"""The mixed step of the port's engine (reduced configs, fp32, CPU): one
forward over an interval's decode rows and its prefill lanes' chunks
(`layers.MixedRows`) against the separate decode and chunk forwards it
replaces, the replays an interval dispatches (`Interval.replays`) against
the interval's chunk plan, the JAX engine's tokens, no step key built
after the warm-up the benchmark makes, and the benchmark's reader of the
count."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perfbench import record
from perfbench.drive import capture_tails
from perfbench.registry import HERE, load_module
from repro.config.base import ServeConfig as JServeConfig
from repro.config.registry import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.serving.engine import Engine as JEngine
from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.models.layers import MixedRows
from repro_torch.models.model import build_model
from repro_torch.params import from_jax_params
from repro_torch.serving import engine as E
from repro_torch.serving import trace
from repro_torch.serving.engine import Engine

SERVE = dict(policy="memory", b_max=6, max_new_tokens=5, kv_pool_tokens=4096,
             chunked_prefill=True, chunk_budget_tokens=16, n_prefill_lanes=2,
             paged_kv=True, block_size=16)
ENGINE = dict(max_context=64, buckets=(1, 2, 4, 8), prefill_chunk=8)
_MODELS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
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


def _prompts(n, vocab, seed=0, lo=6, hi=40):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, size=rng.randint(lo, hi))))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the forward


def _pools(m, num_blocks=24, bs=16, seed=0):
    cache = m.init_paged_cache(num_blocks, bs)
    g = torch.Generator().manual_seed(seed)
    for k in ("k", "v"):
        cache[k].copy_(torch.randn(cache[k].shape, generator=g))
    return cache


@pytest.mark.parametrize("lanes", [(5, 8), (3, 0), (0, 0)],
                         ids=["two", "one-idle", "idle"])
def test_mixed_forward_is_the_separate_forwards(lanes):
    """Decode rows (one a padding row) and lane chunks (a lane's tail and
    an idle lane padding) in one forward give the decode rows' logits and
    the pools of a decode forward and one chunk forward a lane."""
    m, p = _model("granite-3-8b")
    bs, C, MB = 16, 8, 4
    vocab = m.cfg.vocab_size
    rng = np.random.RandomState(1)
    # block tables over distinct blocks: 3 decode rows, then the 2 lanes
    blocks = iter(rng.permutation(24))
    tables = np.full((4 + 2, MB), -1, np.int32)
    ctx = [37, 12, 50, -1, 20, 29]     # decode positions; lane starts
    for row in (0, 1, 2, 4, 5):
        for i in range((max(ctx[row], 0) + C) // bs + 1):
            tables[row, i] = next(blocks)
    base = _pools(m)
    # every row's earlier positions written, as earlier steps would have
    for row in (0, 1, 2, 4, 5):
        for t in range(ctx[row]):
            blk, off = tables[row, t // bs], t % bs
            base["pos"][blk, off] = t
    dec_tok = rng.randint(0, vocab, size=4)
    dec_pos = np.array(ctx[:4], np.int32)
    lane_tok = rng.randint(0, vocab, size=(2, C))
    lane_pos = np.full((2, C), -1, np.int32)
    for j, take in enumerate(lanes):
        lane_pos[j, :take] = np.arange(ctx[4 + j], ctx[4 + j] + take)

    mixed = {k: v.clone() for k, v in base.items()}
    rows = MixedRows(4, C, torch.from_numpy(tables))
    got, _ = m.forward(
        p, torch.from_numpy(np.concatenate([dec_tok, lane_tok.ravel()]))[None],
        torch.from_numpy(np.concatenate([dec_pos, lane_pos.ravel()]))[None],
        mixed, tables=rows)

    sep = {k: v.clone() for k, v in base.items()}
    want_dec, _ = m.decode_step_paged(
        p, torch.from_numpy(dec_tok), torch.from_numpy(dec_pos),
        torch.from_numpy(tables[:4]), sep)
    assert got.shape == (1, 4, vocab)
    torch.testing.assert_close(got[0, :3], want_dec[:3])
    for j, take in enumerate(lanes):
        if take:
            m.prefill_paged(p, torch.from_numpy(lane_tok[j:j + 1, :take]),
                            torch.from_numpy(lane_pos[j:j + 1, :take]),
                            torch.from_numpy(tables[4 + j:5 + j]), sep)
    # the same slots written with the same values; the spare block aside
    assert torch.equal(mixed["pos"], sep["pos"])
    for k in ("k", "v"):
        torch.testing.assert_close(mixed[k][:, :-1], sep[k][:, :-1])


def test_mixed_forward_refuses_a_stateful_family():
    m, p = _model("mamba2-2.7b")
    cache = m.init_paged_cache(8, 16, n_slots=2)
    rows = MixedRows(1, 4, torch.full((2, 4), -1, dtype=torch.int32))
    with pytest.raises(ValueError, match="attention-only"):
        m.forward(p, torch.zeros((1, 5), dtype=torch.int64),
                  torch.full((1, 5), -1, dtype=torch.int32), cache,
                  tables=rows, rows=torch.full((2,), 2))


# ---------------------------------------------------------------------------
# the engine: replays an interval, tokens, step keys


def _plans(monkeypatch, eng):
    """Spy on the engine's chunk plans: interval index -> [(take, whether
    the chunk finishes its prompt)]."""
    plans = {}
    pack = E.pack_chunks

    def spy(*a, **k):
        plan = pack(*a, **k)
        plans[len(eng.trace.intervals)] = [
            (t, r.prefill_pos + t >= r.prompt_len) for _, r, t in plan]
        return plan

    monkeypatch.setattr(E, "pack_chunks", spy)
    return plans


def _jax_weights(arch):
    """The JAX model and weights of `arch`, and the port's model on the
    same weights."""
    jm = jax_build(jax_config(arch, "reduced"), dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(get_config(arch, "reduced"), dtype=torch.float32,
                    device="cpu")
    return jm, jp, m, from_jax_params(jax.device_get(jp))


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2-moe-a2.7b",
                                  "mamba2-2.7b"])
def test_replays_an_interval(arch, monkeypatch):
    """granite and the MoE (the mixed path): an interval that decodes
    makes one replay, plus one a distinct size of the chunks that finish
    their prompts, and serves the JAX engine's tokens; one without decode
    rows a chunk step a size. mamba2 (exact-size chunks): a chunk step a
    size, plus the decode step."""
    mixed = arch != "mamba2-2.7b"
    if mixed:
        jm, jp, m, p = _jax_weights(arch)
    else:
        m, p = _model(arch)
    eng = Engine(m, p, ServeConfig(**SERVE), device="cpu", **ENGINE)
    assert eng.mixed == mixed
    plans = _plans(monkeypatch, eng)
    prompts = _prompts(6, m.cfg.vocab_size)
    hs = [eng.submit(t, max_new_tokens=5) for t in prompts]
    eng.run()
    seen = {"alone": 0, "finishing": 0, "chunks only": 0}
    for i, iv in enumerate(eng.trace.intervals):
        plan = plans.get(i, [])
        sizes = {t for t, _ in plan}
        if not iv.n_decode:
            want = len(sizes)
            seen["chunks only"] += bool(plan)
        elif mixed and plan:
            ends = {t for t, fin in plan if fin}
            want = 1 + len(ends)
            seen["finishing" if ends else "alone"] += 1
        else:
            want = len(sizes) + 1
            seen["finishing" if any(f for _, f in plan) else "alone"] += \
                bool(plan)
        assert iv.replays == want, (i, plan, iv.n_decode)
    assert all(seen.values()), seen
    assert all(len(h.output_tokens) == 5 for h in hs)
    if mixed:
        want = [h.output_tokens for h in hs]
        jeng = JEngine(jm, jp, JServeConfig(
            **{k: v for k, v in SERVE.items() if k != "paged_kv"}), **ENGINE)
        jhs = [jeng.submit(t, max_new_tokens=5) for t in prompts]
        jeng.run()
        assert [h.output_tokens for h in jhs] == want
        assert "mixed" in {k[0] for k in eng.graphs.steps}
    else:
        assert "mixed" not in {k[0] for k in eng.graphs.steps}


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
def test_no_step_key_is_built_after_the_benchmarks_warmup(prefix):
    """After `warmup()` and the tail chunks `perfbench.drive.capture_tails`
    builds, serving a chunked paged trace (with prefix sharing: requests
    that share a document) builds no step: on the card nothing is captured
    inside a measured window."""
    m, p = _model("granite-3-8b")
    eng = Engine(m, p, ServeConfig(**dict(SERVE, prefix_cache=prefix)),
                 device="cpu", **ENGINE)
    eng.warmup()
    capture_tails(eng)
    have = set(eng.graphs.steps)
    assert {("mixed", b, n) for b in eng.buckets for n in (1, 2)} <= have
    built = []
    build = eng._build_step
    eng._build_step = lambda key: built.append(key) or build(key)
    doc = _prompts(1, m.cfg.vocab_size, seed=3, lo=32, hi=33)[0]
    prompts = _prompts(8, m.cfg.vocab_size, seed=2, lo=2, hi=30)
    for i, t in enumerate(prompts):
        eng.submit(doc + t if prefix and i % 2 else t, max_new_tokens=5)
        eng.step()
    eng.run()
    assert built == []
    assert eng.summary()["finished"] == len(prompts)
    assert any(iv.replays == 1 and iv.n_decode and iv.prefill_tokens
               for iv in eng.trace.intervals)


# ---------------------------------------------------------------------------
# the benchmark's reader


def test_fused_replays_mean_reads_the_fused_intervals():
    read = load_module(HERE / "metrics" / "fused_replays_mean.py",
                       "pt_fused_replays_mean").read
    tr = trace.EngineTrace()
    for n_decode, prefill, replays in [(2, 16, 9), (4, 0, 1), (4, 16, 1),
                                       (3, 30, 2), (0, 8, 1), (4, 0, 1)]:
        iv = trace.Interval(0.0)
        iv.n_decode, iv.prefill_tokens, iv.replays = n_decode, prefill, \
            replays
        tr.intervals.append(iv)

    def run(i0, i1):
        return record.Run(cell={}, config={}, seconds=1.0, setup_s=1.0,
                          reqs=[], steps=[], start={"host_i": i0},
                          end={"host_i": i1}, batch_trace=[], step_host=[],
                          pool_tokens=1)

    # interval 0 lies before the window
    assert read(run(1, 6)) == pytest.approx(4 / 3)
    assert read(run(5, 6)) is None      # no interval carried a chunk
    assert read(run(1, 7)) is None      # the trace is shorter
