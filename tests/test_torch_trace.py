"""The serving engine's own tracing (`repro_torch.serving.trace`) on the
CPU (reduced configs, fp32): its spans in the profiler's trace, its
per-interval records beside `step_host_trace`, and nothing changed in what
the engine serves whether a profiler collects or not."""
import json

import numpy as np
import pytest
import torch

from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.models.model import build_model
from repro_torch.serving import trace
from repro_torch.serving.engine import Engine

SPANS = ("engine.step", "engine.schedule", "engine.admit", "engine.prefill",
         "engine.decode", "engine.readback", "engine.retire",
         "engine.retire.wait", "step.decode", "step.mixed", "step.chunk")
#: summary() keys that count work (the rest are times, or rest on them)
COUNTERS = ("total_tokens", "decode_steps", "mean_batch", "finished",
            "admitted", "preemptions", "oom_events", "rejected",
            "swap_outs", "swap_ins", "copy_rows", "copy_bytes",
            "prefix_hit_tokens", "prefix_query_tokens", "cached_blocks",
            "cache_evictions", "logical_used_tokens", "physical_used_tokens",
            "prefill_lane_occupancy", "prefill_tokens")
PROMPTS = (5, 9, 17, 4, 23, 12, 30, 7)
_MODELS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch="granite-3-8b"):
    if arch not in _MODELS:
        m = build_model(get_config(arch, "reduced"), dtype=torch.float32,
                        device="cpu")
        _MODELS[arch] = (m, m.init(0))
    return _MODELS[arch]


def _engine(chunked=True, **kw):
    m, p = _model()
    serve = dict(policy="memory", b_max=8, block_size=16, max_new_tokens=6,
                 kv_pool_tokens=1024, paged_kv=True, chunked_prefill=chunked,
                 chunk_budget_tokens=16, n_prefill_lanes=2,
                 batch_buckets=(1, 2, 4, 8), overlap_depth=2)
    serve.update(kw)
    return Engine(m, p, ServeConfig(**serve), max_context=96,
                  buckets=(1, 2, 4, 8), prefill_chunk=8, device="cpu")


def _serve(eng, staggered=False):
    """Submit the prompts (half of them after a few intervals when
    `staggered`, at the engine's clock; else all at time 0) and run to
    idle; returns the requests."""
    rng = np.random.RandomState(0)
    prompts = [list(map(int, rng.randint(0, eng.cfg.vocab_size, size=n)))
               for n in PROMPTS]
    if not staggered:
        hs = [eng.submit(t, arrival_time=0.0) for t in prompts]
        eng.run()
        return hs
    half = len(prompts) // 2
    hs = [eng.submit(t) for t in prompts[:half]]
    for _ in range(3):
        eng.step()
    hs += [eng.submit(t) for t in prompts[half:]]
    eng.run()
    return hs


def _profiled(fn, tmp_path):
    """Run `fn` under a CPU profiler; its result and the exported chrome
    trace's complete events."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [e for e in events if e.get("ph") == "X"]


def test_spans_land_in_the_profilers_trace(tmp_path):
    eng = _engine()
    hs, events = _profiled(lambda: _serve(eng), tmp_path)
    assert all(None not in h.output_tokens for h in hs)
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    for name in SPANS:
        assert name in by, name
        assert {e["cat"] for e in by[name]} == {"user_annotation"}, name
    # one engine.step a busy step(); every wait inside a retirement
    assert len(by["engine.step"]) == len(eng.step_host_trace)
    retires = [(e["tid"], e["ts"], e["ts"] + e["dur"])
               for e in by["engine.retire"]]
    for w in by["engine.retire.wait"]:
        assert any(tid == w["tid"] and a <= w["ts"]
                   and w["ts"] + w["dur"] <= b for tid, a, b in retires)
    # the spans named nothing outside the fixed set
    names = {n for n in by if n.startswith(("engine.", "step.", "graphs."))}
    assert names <= set(SPANS) | {"step.xchunk", "graphs.capture"}


def test_a_first_chunk_with_extras_runs_in_its_own_span(tmp_path):
    m, p = _model("llama-3.2-vision-90b")
    eng = Engine(m, p, ServeConfig(policy="memory", b_max=2,
                                   max_new_tokens=2, kv_pool_tokens=512),
                 max_context=32, buckets=(1, 2), prefill_chunk=8,
                 enc_len=16, device="cpu")
    x = np.random.RandomState(0).randn(1, 16, m.cfg.d_model)
    eng.submit(list(range(1, 12)), extras={"images": x})
    _, events = _profiled(eng.run, tmp_path)
    names = [e["name"] for e in events]
    assert names.count("step.xchunk") == 1
    assert "step.chunk" in names and "step.decode" in names


def test_off_the_spans_are_one_shared_null_and_nothing_is_timed():
    assert not torch.autograd._profiler_enabled()
    assert trace.span(False, "engine.step") is trace.span(False, "x")
    eng = _engine()
    _serve(eng)
    assert eng.trace.intervals
    assert all(iv.device_ms is None for iv in eng.trace.intervals)
    assert trace.latest() is eng.trace


@pytest.mark.parametrize("chunked", [False, True], ids=["fused0", "fused1"])
def test_serving_is_the_same_with_the_profiler_on(chunked, tmp_path):
    off = _engine(chunked)
    h_off = _serve(off)
    on = _engine(chunked)
    h_on, _ = _profiled(lambda: _serve(on), tmp_path)
    assert [h.output_tokens for h in h_on] == \
        [h.output_tokens for h in h_off]
    s_on, s_off = on.summary(), off.summary()
    assert {k: s_on[k] for k in COUNTERS} == {k: s_off[k] for k in COUNTERS}
    assert len(on.trace.intervals) == len(off.trace.intervals)
    # the engine's trace keeps no device time on the CPU
    assert all(iv.device_ms is None for iv in on.trace.intervals)


def test_intervals_align_with_the_engines_records(monkeypatch):
    eng = _engine()
    prefilling = []
    advance = Engine._advance_prefill

    def spy(self, budget, rec):
        prefilling.append(bool(self.prefilling))
        return advance(self, budget, rec)

    monkeypatch.setattr(Engine, "_advance_prefill", spy)
    hs = _serve(eng, staggered=True)
    ivs = eng.trace.intervals
    assert len(ivs) == len(eng.step_host_trace) == len(prefilling)
    assert [iv.n_decode for iv in ivs if iv.n_decode] == eng.batch_trace
    # a budget exactly where a request was prefilling
    assert [iv.chunk_budget is not None for iv in ivs] == prefilling
    assert sum(iv.prefill_tokens for iv in ivs) \
        == eng.tel.prefill_tokens_total > 0
    assert all(a.t <= a.t_end <= b.t for a, b in zip(ivs, ivs[1:]))
    assert eng.trace.requests == hs
    for r in hs:
        assert r.first_token_time >= 0
        assert r.arrival_time <= r.prefill_start_time <= r.first_token_time
    # the whole run as one window holds every request
    w = eng.trace.window(0, len(ivs))
    assert w.requests == hs and w.intervals == ivs


@pytest.mark.parametrize("chunked", [False, True], ids=["fused0", "fused1"])
def test_replays_count_every_step_an_interval_ran(chunked, monkeypatch):
    """`Interval.replays` is 0 on a fresh record and, on every busy
    `step()`, the compiled steps that interval ran."""
    assert trace.Interval(0.0).replays == 0
    eng = _engine(chunked)
    runs, steps = [], []
    run, step = Engine._run, Engine.step

    def counted_run(self, st):
        runs[-1] += 1
        return run(self, st)

    def counted_step(self):
        runs.append(0)
        busy = step(self)
        steps.append(busy)
        return busy

    monkeypatch.setattr(Engine, "_run", counted_run)
    monkeypatch.setattr(Engine, "step", counted_step)
    _serve(eng, staggered=True)
    busy = [n for n, b in zip(runs, steps) if b]
    assert [iv.replays for iv in eng.trace.intervals] == busy
    assert all(n > 0 for n in busy) and sum(busy) == sum(runs)


def test_the_window_takes_the_requests_that_arrived_in_it():
    tr = trace.EngineTrace()
    for k in range(4):
        iv = trace.Interval(0.1 * k)
        iv.t_end = 0.1 * k + 0.05
        tr.intervals.append(iv)

    class R:
        def __init__(self, t):
            self.arrival_time = t

    tr.requests = [R(t) for t in (0.0, 0.06, 0.12, 0.2, 0.26, 0.4)]
    w = tr.window(1, 3)
    assert w.intervals == tr.intervals[1:3]
    # after interval 0 ended (0.05) up to interval 2's end (0.25)
    assert (w.t0, w.t1) == (0.05, 0.25)
    assert [r.arrival_time for r in w.requests] == [0.06, 0.12, 0.2]
    assert [r.arrival_time for r in tr.window(0, 1).requests] == [0.0]
    assert tr.window(2, 2).intervals == []
    assert trace.latest() is tr
