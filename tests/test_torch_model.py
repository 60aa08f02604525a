"""The port's model against the JAX package's, with the same weights
(`params.from_jax_params`), on reduced granite-3-8b in fp32 on the CPU:
single prefill, and chunked prefill + token-by-token decode, against JAX
`forward_train` logits at rtol = atol = 2e-4 (the tolerance of
tests/test_consistency.py); the sliding-window ring; paged == contiguous.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config.base import AttentionKind as JAttentionKind
from repro.config.registry import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro_torch.config.base import AttentionKind
from repro_torch.config.registry import get_config
from repro_torch.models.model import build_model
from repro_torch.params import from_jax_params
from repro_torch.serving.kv_cache import BlockManager

TOL = dict(rtol=2e-4, atol=2e-4)


def models(seed, window=0):
    jcfg, cfg = jax_config("granite-3-8b", "reduced"), \
        get_config("granite-3-8b", "reduced")
    if window:
        jcfg = dataclasses.replace(jcfg, attention=JAttentionKind.SLIDING,
                                   sliding_window=window)
        cfg = dataclasses.replace(cfg, attention=AttentionKind.SLIDING,
                                  sliding_window=window)
    jm = jax_build(jcfg, dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(seed))
    m = build_model(cfg, dtype=torch.float32, device="cpu")
    return cfg, jm, jp, m, from_jax_params(jax.device_get(jp))


def reference_logits(jm, jp, toks):
    full, _ = jm.forward_train(jp, {"tokens": jnp.asarray(toks)}, remat=False)
    return np.asarray(full)


def test_prefill_and_decode_match_jax_forward():
    cfg, jm, jp, m, p = models(1)
    B, T, split = 2, 24, 16
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, T))
    full = reference_logits(jm, jp, toks.astype(np.int32))
    tt = torch.from_numpy(toks)
    pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)

    # path A: single prefill
    lgA, _ = m.prefill(p, tt, pos, m.init_cache(B, 64))
    np.testing.assert_allclose(lgA.numpy(), full, **TOL)

    # path B: chunked prefill + token-by-token decode
    cache = m.init_cache(B, 64)
    lgB, cache = m.prefill(p, tt[:, :split], pos[:, :split], cache)
    outs = [lgB]
    for t in range(split, T):
        lg, cache = m.decode_step(p, tt[:, t],
                                  torch.full((B,), t, dtype=torch.int32),
                                  cache)
        outs.append(lg[:, None])
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full, **TOL)


def test_sliding_window_ring_buffer_matches_jax():
    """Ring cache (window 8 + chunk 4 - 1 = 11 slots < context 20) equals
    the JAX windowed full-sequence forward."""
    cfg, jm, jp, m, p = models(2, window=8)
    B, T = 1, 20
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, T))
    full = reference_logits(jm, jp, toks.astype(np.int32))
    cache = m.init_cache(B, 32, prefill_chunk=4)
    assert cache["k"].shape[2] == 11
    tt = torch.from_numpy(toks)
    pos = torch.arange(T, dtype=torch.int32)[None]
    outs = []
    for s in range(0, T, 4):
        lg, cache = m.prefill(p, tt[:, s:s + 4], pos[:, s:s + 4], cache)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full, **TOL)


def test_paged_equals_contiguous():
    """Ragged prefill (padding rows) then decode: the paged pools give the
    contiguous cache's logits bit for bit, and padding never writes."""
    cfg, _, _, m, p = models(0)
    rng = np.random.RandomState(0)
    max_ctx, bs, n_new = 64, 16, 6
    lens = [12, 9]
    B, T = len(lens), max(lens)
    toks = torch.zeros(B, T, dtype=torch.int64)
    pos = torch.full((B, T), -1, dtype=torch.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = torch.from_numpy(rng.randint(0, cfg.vocab_size, n))
        pos[i, :n] = torch.arange(n)
    cache_c = m.init_cache(B, max_ctx)
    bm = BlockManager(total_tokens=256, block_size=bs)
    tables = torch.full((B, -(-max_ctx // bs)), -1, dtype=torch.int32)
    for i, n in enumerate(lens):
        assert bm.allocate(i, 0, n + n_new + 1)
        ids = bm.table(i)
        tables[i, :len(ids)] = torch.tensor(ids)
    cache_p = m.init_paged_cache(bm.num_blocks, bs)
    lg_c, cache_c = m.prefill(p, toks, pos, cache_c)
    lg_p, cache_p = m.prefill_paged(p, toks, pos, tables, cache_p)
    torch.testing.assert_close(lg_c, lg_p, rtol=0, atol=0)
    # padding tokens wrote nothing
    assert int((cache_p["pos"] >= 0).sum()) == sum(lens)
    cur = list(lens)
    nxt = [int(lg_c[i, n - 1].argmax()) for i, n in enumerate(lens)]
    for _ in range(n_new):
        tt, sl = torch.tensor(nxt), torch.tensor(cur, dtype=torch.int32)
        lg_c, cache_c = m.decode_step(p, tt, sl, cache_c)
        lg_p, cache_p = m.decode_step_paged(p, tt, sl, tables, cache_p)
        torch.testing.assert_close(lg_c, lg_p, rtol=0, atol=0)
        nxt = [int(x) for x in lg_c.argmax(-1)]
        cur = [c + 1 for c in cur]
