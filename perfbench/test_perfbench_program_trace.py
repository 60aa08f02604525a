"""The readers of the engine's own trace (`repro_torch.serving.trace`):
their values on a trace built by hand, nothing where the program keeps no
such trace, the device-trace reading untouched by the engine's ranges, and
their entries in BENCHMARK.json."""
import sys

import pytest

from perfbench import profile, record
from perfbench.registry import HERE, Bench, load_module

READERS = ("ttft_queue_ms_p90", "ttft_prefill_ms_p90", "chunk_budget_mean",
           "decode_interval_device_ms", "fused_interval_device_ms")


def metric(name):
    return load_module(HERE / "metrics" / f"{name}.py", "pt_" + name).read


def run_of(i0, i1):
    return record.Run(cell={}, config={}, seconds=1.0, setup_s=1.0,
                      reqs=[], steps=[], start={"host_i": i0},
                      end={"host_i": i1}, batch_trace=[], step_host=[],
                      pool_tokens=1000)


def built_trace():
    """Interval 0 lies before the window (1-4); so do requests that arrived
    before it ended (0.01) or after interval 4 ended (0.10)."""
    from repro_torch.serving import trace
    from repro_torch.serving.request import Request

    tr = trace.EngineTrace()
    rows = [  # t, t_end, n_decode, prefill_tokens, chunk_budget, device_ms
        (0.00, 0.01, 2, 0, None, 99.0),
        (0.01, 0.03, 4, 0, None, 10.0),
        (0.03, 0.06, 4, 16, 16, 25.0),
        (0.06, 0.08, 0, 8, 30, None),
        (0.08, 0.10, 3, 0, 0, 12.0)]
    for t, t_end, n, pt, b, ms in rows:
        iv = trace.Interval(t)
        iv.t_end, iv.n_decode, iv.prefill_tokens = t_end, n, pt
        iv.chunk_budget, iv.device_ms = b, ms
        tr.intervals.append(iv)
    reqs = [  # arrival, prefill_start, first_token, rejected
        (0.005, 0.02, 0.05, False),    # before the window
        (0.01, 0.03, 0.07, False),     # queue 20 ms, prefill 40 ms
        (0.02, 0.06, -1.0, False),     # queue 40 ms, prefill 40 ms so far
        (0.05, -1.0, -1.0, False),     # queue 50 ms so far
        (0.07, -1.0, -1.0, True),      # refused: no reading
        (0.20, -1.0, -1.0, False)]     # after the window
    for i, (a, ps, ft, rej) in enumerate(reqs):
        r = Request(rid=i, arrival_time=a, prompt_tokens=[1, 2, 3])
        r.prefill_start_time, r.first_token_time, r.rejected = ps, ft, rej
        tr.requests.append(r)
    return tr


def test_readers_on_a_built_trace():
    built_trace()
    run = run_of(1, 5)
    assert metric("ttft_queue_ms_p90")(run) == pytest.approx(50.0)
    assert metric("ttft_prefill_ms_p90")(run) == pytest.approx(40.0)
    assert metric("chunk_budget_mean")(run) == pytest.approx(46 / 3)
    assert metric("decode_interval_device_ms")(run) == pytest.approx(11.0)
    assert metric("fused_interval_device_ms")(run) == pytest.approx(25.0)
    # a narrower window: interval 2 alone, the requests of (0.03, 0.06]
    run = run_of(2, 3)
    assert metric("ttft_queue_ms_p90")(run) == pytest.approx(50.0 - 40.0)
    assert metric("chunk_budget_mean")(run) == 16
    assert metric("decode_interval_device_ms")(run) is None
    assert metric("ttft_prefill_ms_p90")(run) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_readings(name, monkeypatch):
    from repro_torch.serving import trace

    tr = built_trace()
    # the trace shorter than the window; no window recorded
    assert metric(name)(run_of(1, 6)) is None
    assert metric(name)(record.Run(
        cell={}, config={}, seconds=1.0, setup_s=1.0, reqs=[], steps=[],
        start={}, end={}, batch_trace=[], step_host=[], pool_tokens=1)) \
        is None
    # a window without a reading: untimed, no budget, no request
    for iv in tr.intervals:
        iv.device_ms, iv.chunk_budget = None, None
    tr.requests = []
    assert metric(name)(run_of(1, 5)) is None
    # the program without the module (a tree before it)
    monkeypatch.setitem(sys.modules, "repro_torch.serving.trace", None)
    monkeypatch.delattr(sys.modules["repro_torch.serving"], "trace")
    built = run_of(1, 5)
    assert metric(name)(built) is None
    monkeypatch.undo()
    assert trace.latest() is tr


def _events():
    """A traced slice: two harness ranges, kernels and a copy, with idle
    gaps at 30-40 µs (in .step) and 70-80 µs (in .account)."""
    return [
        {"ph": "X", "name": "perfbench.step", "cat": "user_annotation",
         "ts": 0.0, "dur": 60.0},
        {"ph": "X", "name": "perfbench.account", "cat": "user_annotation",
         "ts": 60.0, "dur": 40.0},
        {"ph": "X", "name": "gemm", "cat": "kernel", "ts": 0.0,
         "dur": 30.0},
        {"ph": "X", "name": "Memcpy DtoH", "cat": "gpu_memcpy", "ts": 40.0,
         "dur": 30.0},
        {"ph": "X", "name": "decode", "cat": "kernel", "ts": 80.0,
         "dur": 20.0}]


def test_engine_ranges_leave_the_device_reading_as_it_was():
    plain = profile.read_events(_events())
    assert plain.busy_s == pytest.approx(80e-6)
    ranges = [  # engine ranges over the gaps, on the host and the device
        {"ph": "X", "name": "engine.step", "cat": "user_annotation",
         "ts": 1.0, "dur": 58.0},
        {"ph": "X", "name": "engine.retire.wait", "cat": "user_annotation",
         "ts": 29.0, "dur": 12.0},
        {"ph": "X", "name": "step.decode", "cat": "user_annotation",
         "ts": 65.0, "dur": 20.0},
        {"ph": "X", "name": "engine.decode", "cat": "gpu_user_annotation",
         "ts": 25.0, "dur": 60.0},
        {"ph": "X", "name": "step.chunk", "cat": "gpu_user_annotation",
         "ts": 68.0, "dur": 14.0}]
    traced = profile.read_events(_events() + ranges)
    assert traced == plain
    assert [n for n, _ in traced.idle_gaps] == ["perfbench.step",
                                                "perfbench.account"]


@pytest.mark.parametrize("name", READERS)
def test_entries_agree_with_their_readers(name):
    b = Bench()
    entry = next(m for m in b.spec["per_layer"] if m["name"] == name)
    assert "workloads" not in entry
    b.reader(entry)
    mod = load_module(HERE / "metrics" / f"{name}.py", "pe_" + name)
    assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.BETTER, mod.SOURCE) == (
        entry["layer"], entry["unit"], entry["moves"], entry["better"],
        entry["source"])
    # each cell reports the end-to-end metric it moves
    for w in b.spec["workloads"]:
        assert b.metrics(w["name"], True).count(entry) == 1
        assert entry["moves"] in {m["name"]
                                  for m in b.metrics(w["name"], False)}


def test_a_traced_tiny_run_reports_the_program_readers(tiny, tiny_cell):
    from perfbench.cell import run_cell

    tiny.add_cell("tiny-short", "tiny", "mix",
                  dict(tiny_cell, trace_seconds=0.05))
    out = run_cell(tiny.bench(), "tiny-short", 11, 1.0, True, "cpu")
    assert out["correct"], out["check"]
    m = out["metrics"]
    for name in ("ttft_queue_ms_p90", "ttft_prefill_ms_p90",
                 "chunk_budget_mean"):
        assert m[name]["value"] >= 0.0, name
    # the CPU times no interval on a device
    assert "decode_interval_device_ms" not in m
    assert "fused_interval_device_ms" not in m
