"""Async dispatch-ahead in the port's engine (DESIGN §14), on the CPU
(reduced configs, fp32).

* Depth 1 and 2 against depth 0, bit for bit (tests/test_async_overlap.py
  on the port): the same output tokens, step count and scheduling counters
  in all three families, both cache layouts, chunked prefill on and off.
* The port at depth k against the JAX engine at depth k, with the same
  weights: tokens, counters, and the block tables after every step (the
  shadow epochs decide which block ids are reused).
* The staging ring: no arena is rewound, or staged into, while its
  interval is in flight, and its pinned bytes stay as staged until then.
* `--trace` through the port CLI gives the JAX engine's tokens for the
  same trace.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import ServeConfig as JServeConfig
from repro.config.registry import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.serving import workload as jw
from repro.serving.engine import Engine as JEngine
from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.launch import serve as port_serve
from repro_torch.models.model import Model, build_model
from repro_torch.params import from_jax_params
from repro_torch.serving import graphs
from repro_torch.serving.engine import Engine
from repro_torch.serving.graphs import Staging

FAMILIES = ("granite-3-8b", "mamba2-2.7b", "recurrentgemma-9b")
MAX_CONTEXT = 96
COUNTERS = ("finished", "admitted", "preemptions", "oom_events", "rejected",
            "decode_steps", "total_tokens", "prefill_tokens", "copy_rows",
            "mean_batch")
_MODELS = {}
_DEPTH0 = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced engines run many tiny ops: one intra-op thread serves
    them faster than a pool, and keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch):
    if arch not in _MODELS:
        m = build_model(get_config(arch, "reduced"), dtype=torch.float32,
                        device="cpu")
        _MODELS[arch] = (m, m.init(0))
    return _MODELS[arch]


def _serve_kw(depth, paged, chunked, pool_tokens=1024, policy="memory",
              max_new=6):
    return dict(policy=policy, b_max=8, block_size=16,
                max_new_tokens=max_new,
                kv_pool_tokens=pool_tokens, paged_kv=paged,
                chunked_prefill=chunked, chunk_budget_tokens=16,
                n_prefill_lanes=2, batch_buckets=(1, 2, 4, 8),
                overlap_depth=depth)


PROMPTS = (5, 9, 17, 4, 23, 12)


def _prompts(vocab, lens=PROMPTS, seed=0):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, size=n))) for n in lens]


def run_engine(arch, depth, paged, chunked, lens=PROMPTS, seed=0, **kw):
    """(steps, per-request outputs, summary, engine) of one full run."""
    m, p = _model(arch)
    eng = Engine(m, p, ServeConfig(**_serve_kw(depth, paged, chunked, **kw)),
                 max_context=MAX_CONTEXT, buckets=(1, 2, 4, 8),
                 prefill_chunk=8, device="cpu")
    hs = [eng.submit(t, arrival_time=0.0)
          for t in _prompts(m.cfg.vocab_size, lens, seed)]
    steps = eng.run(max_steps=20_000)
    for h in hs:
        assert all(t is not None for t in h.output_tokens), h.rid
    return steps, [tuple(h.output_tokens) for h in hs], eng.summary(), eng


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("chunked", [False, True], ids=["fused0", "fused1"])
@pytest.mark.parametrize("paged", [False, True],
                         ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_bitwise_sync_vs_async(arch, paged, chunked, depth):
    key = (arch, paged, chunked)
    if key not in _DEPTH0:
        _DEPTH0[key] = run_engine(arch, 0, paged, chunked)[:3]
    s0, o0, m0 = _DEPTH0[key]
    s1, o1, m1, eng = run_engine(arch, depth, paged, chunked)
    assert o1 == o0
    assert s1 == s0
    assert {k: m1[k] for k in COUNTERS} == {k: m0[k] for k in COUNTERS}
    # the pipeline drained before run() reported idle
    assert not eng._inflight and not eng._staging._in_flight
    assert len(eng.tbt_trace) == eng.decode_steps


def test_bitwise_under_preemption_pressure():
    """A pool tight enough to preempt (recompute): an evicted life's
    un-retired patches drop, its regenerated tokens are depth 0's."""
    kw = dict(pool_tokens=160, policy="static", max_new=12,
              lens=(40, 44, 38, 46), seed=1)
    s0, o0, m0, _ = run_engine("granite-3-8b", 0, True, True, **kw)
    for depth in (1, 2):
        s1, o1, m1, _ = run_engine("granite-3-8b", depth, True, True, **kw)
        assert (s1, o1) == (s0, o0), depth
        assert {k: m1[k] for k in COUNTERS} == {k: m0[k] for k in COUNTERS}
    assert m0["preemptions"] > 0


def test_depth_two_keeps_two_intervals_in_flight(monkeypatch):
    """At depth 2 a step retires only once two later intervals are in
    flight: the first two dispatching steps retire nothing, and every
    record retires in dispatch order."""
    retired, depths = [], []
    retire = Engine._retire_step

    def spy(self):
        depths.append(len(self._inflight))
        retired.append(self._inflight[0].arena)
        return retire(self)

    monkeypatch.setattr(Engine, "_retire_step", spy)
    m, p = _model("granite-3-8b")
    eng = Engine(m, p, ServeConfig(**_serve_kw(2, True, True)),
                 max_context=MAX_CONTEXT, buckets=(1, 2, 4, 8),
                 prefill_chunk=8, device="cpu")
    for t in _prompts(m.cfg.vocab_size):
        eng.submit(t, arrival_time=0.0)
    assert eng.step() and eng.step()
    assert not retired and len(eng._inflight) == 2
    eng.run()
    assert depths[0] == 3 and max(depths) == 3
    assert retired[:6] == [0, 1, 2, 0, 1, 2]


# ---------------------------------------------------------------------------
# the port at depth k against the JAX engine at depth k


@pytest.fixture(scope="module")
def jax_weights():
    jcfg = jax_config("granite-3-8b", "reduced")
    jm = jax_build(jcfg, dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(get_config("granite-3-8b", "reduced"),
                    dtype=torch.float32, device="cpu")
    return jcfg, jm, jp, m, from_jax_params(jax.device_get(jp))


def _tables(eng, port):
    if port:
        return {r: eng.blocks.table(r) for r in eng.blocks.block_tables}
    return {r: list(t) for r, t in eng.blocks.tables.items()}


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("paged", [False, True],
                         ids=["contiguous", "paged"])
def test_port_matches_jax_engine_at_depth(jax_weights, paged, depth):
    """Step for step: the same block tables after every step() (shadow
    epochs included), then the same tokens and counters."""
    jcfg, jm, jp, m, p = jax_weights
    kw = _serve_kw(depth, paged, True, pool_tokens=160, policy="static",
                   max_new=12)
    eng_kw = dict(max_context=MAX_CONTEXT, buckets=(1, 2, 4, 8),
                  prefill_chunk=8)
    ref = JEngine(jm, jp, JServeConfig(**kw), **eng_kw)
    ours = Engine(m, p, ServeConfig(**kw), device="cpu", **eng_kw)
    prompts = _prompts(jcfg.vocab_size, (40, 44, 38, 46, 9), seed=1)
    hs = [(ours.submit(t, arrival_time=0.0),
           ref.submit(t, arrival_time=0.0)) for t in prompts]
    n = 0
    while True:
        a, b = ours.step(), ref.step()
        assert a == b, n
        assert _tables(ours, True) == _tables(ref, False), n
        assert len(ours._inflight) == len(ref._inflight), n
        if not a:
            break
        n += 1
    assert [h.output_tokens for h, _ in hs] \
        == [h.output_tokens for _, h in hs]
    s, js = ours.summary(), ref.summary()
    assert {k: s[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    assert s["preemptions"] > 0


# ---------------------------------------------------------------------------
# the staging ring


def test_staging_ring_never_rewinds_an_arena_in_flight():
    """Three intervals staged at depth 2: each arena's pinned bytes stay
    as staged while its interval is in flight, staging into a fourth
    interval raises until the oldest retires, and release rewinds only
    the retired arena."""
    st = Staging(torch.device("cpu"), nbytes=64, depth=2)
    dst = torch.empty(6, dtype=torch.int64)
    staged = []
    for i in range(3):
        st.copy(dst, np.arange(6) + 10 * i)
        back = st.readback(dst)
        staged.append((st._ring[i].buf.clone(), back))
        assert st.seal() == i
    for i, (buf, back) in enumerate(staged):
        assert torch.equal(st._ring[i].buf, buf)
        assert back.tolist() == list(range(10 * i, 10 * i + 6))
    with pytest.raises(RuntimeError, match="in flight"):
        st.copy(dst, np.arange(6))
    with pytest.raises(RuntimeError, match="in flight"):
        st.seal()
    st.release(0)
    assert st._ring[0].off == 0 and st._ring[1].off > 0
    st.copy(dst, np.arange(6))
    assert torch.equal(st._ring[1].buf, staged[1][0])
    assert st.seal() == 0 and st._in_flight == [1, 2, 0]


def test_engine_stages_only_into_arenas_not_in_flight(monkeypatch):
    """Over a served run at depth 2 every staged copy and readback lands
    in the open arena, which is never one still in flight, and arenas are
    released in the order they were sealed."""
    events = []
    take, release, seal = graphs._Arena.take, Staging.release, Staging.seal

    def spy_take(arena, dtype, shape):
        events.append(("take", id(arena)))
        return take(arena, dtype, shape)

    def spy_seal(self):
        i = seal(self)
        events.append(("seal", id(self._ring[i])))
        return i

    def spy_release(self, i):
        events.append(("release", id(self._ring[i])))
        return release(self, i)

    monkeypatch.setattr(graphs._Arena, "take", spy_take)
    monkeypatch.setattr(Staging, "seal", spy_seal)
    monkeypatch.setattr(Staging, "release", spy_release)
    run_engine("granite-3-8b", 2, True, True)
    flying = []
    for kind, a in events:
        if kind == "take":
            assert a not in flying
        elif kind == "seal":
            flying.append(a)
        else:
            assert flying.pop(0) == a
    assert not flying and sum(k == "seal" for k, _ in events) > 6


# ---------------------------------------------------------------------------
# --trace through the port CLI


def test_cli_trace_gives_the_jax_engines_tokens(jax_weights, tmp_path,
                                               monkeypatch):
    """The port CLI at depth 2 replays a trace file as the JAX CLI does
    (file order, max_new = max(1, min(l_out, --max-new))): the JAX engine
    served the same way, with the same weights, gives the same tokens."""
    jcfg, jm, jp, m, p = jax_weights
    path = tmp_path / "trace.jsonl"
    jw.save_trace(str(path), jw.reference_trace(
        9, seed=2, vocab_size=4 * jcfg.vocab_size, n_system_prompts=2,
        system_len=12, user_mean=8.0, out_mean=5.0))
    argv = ["--trace", str(path), "--max-new", "4", "--chunked", "--lanes",
            "2", "--paged", "--overlap-depth", "2", "--max-context", "96",
            "--b-max", "4"]
    args = port_serve.build_parser().parse_args(argv + ["--device", "cpu"])
    # the JAX weights through the port's CLI
    monkeypatch.setattr(Model, "init", lambda self, seed=0: p)
    handles = []
    submit = Engine.submit

    def kept(self, *a, **k):
        handles.append(submit(self, *a, **k))
        return handles[-1]

    monkeypatch.setattr(Engine, "submit", kept)
    eng = port_serve.run(args)
    assert eng.overlap_depth == 2

    ref = JEngine(jm, jp, JServeConfig(**_jax_cli_serve(args)),
                  max_context=96, buckets=(1, 2, 4), prefill_chunk=16)
    reqs = jw.trace_prompts(jw.load_trace_events(str(path)),
                            jcfg.vocab_size, seed=0)
    want = [ref.submit(t, max_new_tokens=max(1, min(lo, 4)))
            for t, lo in reqs]
    ref.run()
    assert len(handles) == len(want) == 9
    assert [h.output_tokens for h in handles] \
        == [h.output_tokens for h in want]
    assert any(len(h.output_tokens) < 4 for h in handles)


def _jax_cli_serve(args):
    """The JAX CLI's ServeConfig for the same flags (the port's
    `serve_config` builds the port's from the same fields)."""
    return {f: getattr(port_serve.serve_config(args), f) for f in (
        "policy", "b_min", "b_max", "d_sla_ms", "ttft_sla_s", "tbt_sla_ms",
        "eps_d_ms", "eps_m", "alpha", "delta", "block_size",
        "hbm_budget_bytes", "l0_refresh_interval", "max_new_tokens",
        "batch_buckets", "kv_pool_tokens", "chunked_prefill",
        "chunk_budget_tokens", "n_prefill_lanes", "prefill_pack", "paged_kv",
        "prefix_cache", "swap_space_blocks", "preempt", "overlap_depth",
        "mesh_shape")}
