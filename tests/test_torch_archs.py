"""The other decoder-only families in the port against the JAX package,
with the same weights (`params.from_jax_params`), reduced configs, fp32 on
the CPU: starcoder2-7b (G 2 here, 9 at full width), mistral-nemo-12b (and
its sliding variant through a ring that wraps, with head_dim != d_model /
H as at full width), qwen1.5-32b (MHA with QKV biases) and the MoE family
(qwen2-moe-a2.7b, kimi-k2-1t-a32b).

* Chunked prefill plus token-by-token decode, contiguous and paged,
  against JAX `forward_train` (no_drop, as serving dispatches) at rtol =
  atol = 2e-4 (tests/test_torch_model.py).
* The engine's greedy tokens and structural counters against the JAX
  `Engine`'s, in both cache layouts, on two setups of
  tests/test_torch_engine.py (`memory`, `chunked-2-lanes`), for the four
  servable archs and mistral-nemo's sliding variant on a ring that wraps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import COUNTERS, SETUPS, _prompts, _serve

from repro.config.base import AttentionKind as JAttentionKind
from repro.config.base import ServeConfig as JServeConfig
from repro.config.registry import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.serving.engine import Engine as JEngine
from repro_torch.config.base import AttentionKind, ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.models.model import build_model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_cache import BlockManager

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("starcoder2-7b", "mistral-nemo-12b", "qwen1.5-32b",
         "qwen2-moe-a2.7b", "kimi-k2-1t-a32b")
#: the archs that serve on one H100 at full width
SERVED = ARCHS[:4]
_W = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many tiny ops: one intra-op thread serves them faster than a pool,
    and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(arch, window=0, seed=0, head_dim=0):
    """(JAX config, JAX model, JAX params, port model, port params) of the
    reduced `arch`, sliding over `window` tokens and with `head_dim` if
    given."""
    key = (arch, window, seed, head_dim)
    if key not in _W:
        jcfg, cfg = jax_config(arch, "reduced"), get_config(arch, "reduced")
        if head_dim:
            jcfg = dataclasses.replace(jcfg, head_dim=head_dim)
            cfg = dataclasses.replace(cfg, head_dim=head_dim)
        if window:
            jcfg = dataclasses.replace(jcfg, attention=JAttentionKind.SLIDING,
                                       sliding_window=window)
            cfg = dataclasses.replace(cfg, attention=AttentionKind.SLIDING,
                                      sliding_window=window)
        jm = jax_build(jcfg, dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(seed))
        m = build_model(cfg, dtype=torch.float32, device="cpu")
        _W[key] = (jcfg, jm, jp, m, from_jax_params(jax.device_get(jp)))
    return _W[key]


def reference_logits(jm, jp, toks):
    full, _ = jm.forward_train(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                               remat=False, no_drop=True)
    return np.asarray(full)


def paged_tables(m, lens, max_ctx, bs=8):
    """A paged cache and (B, MB) block tables holding `lens[b]` tokens a
    row, from the allocator."""
    bm = BlockManager(total_tokens=512, block_size=bs)
    tables = torch.full((len(lens), -(-max_ctx // bs)), -1,
                        dtype=torch.int32)
    for i, n in enumerate(lens):
        assert bm.allocate(i, 0, n)
        ids = bm.table(i)
        tables[i, :len(ids)] = torch.tensor(ids)
    return m.init_paged_cache(bm.num_blocks, bs), tables


def chunked_logits(m, p, toks, chunk, paged, max_ctx=64):
    """Logits of `toks` (B, T) prefilled in chunks of `chunk` tokens, the
    last few decoded token by token; contiguous or paged."""
    B, T = toks.shape
    split = T - 5
    tt = torch.from_numpy(toks)
    pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
    if paged:
        cache, tables = paged_tables(m, [T] * B, max_ctx)
    else:
        cache = m.init_cache(B, max_ctx, prefill_chunk=chunk)
    outs = []
    for s in range(0, split, chunk):
        e = min(s + chunk, split)
        if paged:
            lg, cache = m.prefill_paged(p, tt[:, s:e], pos[:, s:e], tables,
                                        cache)
        else:
            lg, cache = m.prefill(p, tt[:, s:e], pos[:, s:e], cache)
        outs.append(lg)
    for t in range(split, T):
        if paged:
            lg, cache = m.decode_step_paged(p, tt[:, t], pos[:, t], tables,
                                            cache)
        else:
            lg, cache = m.decode_step(p, tt[:, t], pos[:, t], cache)
        outs.append(lg[:, None])
    return torch.cat(outs, 1).numpy(), cache


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_forward(arch, paged):
    jcfg, jm, jp, m, p = weights(arch, seed=1)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 21))
    got, _ = chunked_logits(m, p, toks, chunk=8, paged=paged)
    np.testing.assert_allclose(got, reference_logits(jm, jp, toks), **TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_mistral_nemo_sliding_ring_wraps_and_matches_jax(paged):
    """mistral-nemo's sliding variant (window 8) with heads of 48 (q and o
    projections 128 <-> 192, as 5120 <-> 4096 at full width): the
    contiguous ring of 8 + 4 - 1 = 11 slots wraps three times over 37
    tokens, the paged pool keeps every token and masks keys 8 or more
    positions back; both give the JAX windowed forward's logits."""
    jcfg, jm, jp, m, p = weights("mistral-nemo-12b", window=8, seed=2,
                                 head_dim=48)
    assert m.cfg.resolved_head_dim * m.cfg.num_heads != m.cfg.d_model
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size, (2, 37))
    got, cache = chunked_logits(m, p, toks, chunk=4, paged=paged)
    if not paged:
        assert cache["k"].shape[2] == 11
        assert int(cache["pos"].max()) == 36
    np.testing.assert_allclose(got, reference_logits(jm, jp, toks), **TOL)


#: the served archs, and mistral-nemo's sliding variant with a window of 8
#: and heads of 48: its contiguous ring (8 + 8 - 1 = 15 slots) wraps under
#: the setups' longest contexts (16 + 6 and 27 + 5 tokens), with two lanes
#: gathering rows of it in `chunked-2-lanes`
ENGINE_CASES = {**{a: dict(arch=a) for a in SERVED},
                "mistral-nemo-12b-swa": dict(arch="mistral-nemo-12b",
                                             window=8, head_dim=48)}


@pytest.mark.parametrize("setup", ["memory", "chunked-2-lanes"])
@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_matches_jax_engine(case, setup):
    """tests/test_torch_engine.py's check on the arch: the JAX engine on
    its contiguous cache, the port in both layouts, the same tokens and
    counters."""
    jcfg, jm, jp, m, p = weights(**ENGINE_CASES[case])
    serve_kw, eng_kw, (seed, n, lo, hi), max_new = SETUPS[setup]
    prompts = _prompts(seed, n, lo, hi, jcfg.vocab_size)
    want, jsum = _serve(JEngine(jm, jp, JServeConfig(**serve_kw), **eng_kw),
                        prompts, max_new)
    assert jsum["finished"] == n
    for paged in (False, True):
        eng = Engine(m, p, ServeConfig(paged_kv=paged, **serve_kw),
                     device="cpu", **eng_kw)
        if jcfg.sliding_window and not paged:
            ring = eng.cache["k"].shape[2]
            assert ring < max(len(q) for q in prompts) + max_new
        got, s = _serve(eng, prompts, max_new)
        assert got == want, (case, setup, paged)
        assert {k: s[k] for k in COUNTERS} == {k: jsum[k] for k in COUNTERS}
