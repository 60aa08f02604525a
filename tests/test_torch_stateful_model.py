"""The port's stateful families against the JAX package, with the same
weights (`params.from_jax_params`), on reduced mamba2-2.7b (SSM) and
recurrentgemma-9b (RG-LRU + local attention) in fp32 on the CPU: the
chunked SSD scan, single prefill and chunked prefill + token-by-token
decode against JAX `forward_train` at rtol = atol = 2e-4 (the tolerance of
tests/test_consistency.py), the hybrid's attention ring, paged ==
contiguous bit for bit, and the fp32 leaves of a bf16 tree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.registry import get_config as jax_config
from repro.models import ssm as jssm
from repro.models.model import build_model as jax_build
from repro_torch.config.registry import get_config
from repro_torch.models import ssm
from repro_torch.models.model import build_model
from repro_torch.params import from_jax_params

TOL = dict(rtol=2e-4, atol=2e-4)
FAMILIES = ["mamba2-2.7b", "recurrentgemma-9b"]


def models(arch, seed, window=0):
    """(port config, JAX model, JAX params, port model, port params);
    `window` overrides recurrentgemma's attention window."""
    jcfg, cfg = jax_config(arch, "reduced"), get_config(arch, "reduced")
    if window:
        jcfg, cfg = (dataclasses.replace(c, rglru=dataclasses.replace(
            c.rglru, window_size=window)) for c in (jcfg, cfg))
    jm = jax_build(jcfg, dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(seed))
    m = build_model(cfg, dtype=torch.float32, device="cpu")
    return cfg, jm, jp, m, from_jax_params(jax.device_get(jp))


def reference_logits(jm, jp, toks):
    full, _ = jm.forward_train(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                               remat=False)
    return np.asarray(full)


def test_ssd_chunked_matches_jax_with_ragged_tail_and_state():
    """T = 45 over chunks of 16 (a zero-dt padded tail) from a nonzero
    initial state: outputs and the final state."""
    rng = np.random.RandomState(0)
    B, T, H, P, N, chunk = 2, 45, 3, 8, 5, 16
    x, dt, A = rng.randn(B, T, H, P), rng.uniform(1e-3, 0.1, (B, T, H)), \
        -np.arange(1, H + 1, dtype=np.float64)
    Bm, Cm, h0 = rng.randn(B, T, N), rng.randn(B, T, N), rng.randn(B, H, P, N)
    args = [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]
    y, hT = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk,
                            h0=torch.from_numpy(h0.astype(np.float32)))
    jy, jhT = jssm.ssd_chunked(*map(jnp.asarray, args), chunk,
                               h0=jnp.asarray(h0, jnp.float32))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jhT), **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_jax_forward(arch):
    cfg, jm, jp, m, p = models(arch, 1)
    B, T, split = 2, 24, 16
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, T))
    full = reference_logits(jm, jp, toks)
    tt = torch.from_numpy(toks)
    pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)

    # path A: single prefill
    lgA, _ = m.prefill(p, tt, pos, m.init_cache(B, 64))
    np.testing.assert_allclose(lgA.numpy(), full, **TOL)

    # path B: chunked prefill + token-by-token decode
    cache = m.init_cache(B, 64, prefill_chunk=split)
    lgB, cache = m.prefill(p, tt[:, :split], pos[:, :split], cache)
    outs = [lgB]
    for t in range(split, T):
        lg, cache = m.decode_step(p, tt[:, t],
                                  torch.full((B,), t, dtype=torch.int32),
                                  cache)
        outs.append(lg[:, None])
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full, **TOL)


def test_mamba2_multi_chunk_prefill_matches_jax():
    """A 70-token prefill spans three SSD chunks of 32, the last padded."""
    cfg, jm, jp, m, p = models("mamba2-2.7b", 3)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 70))
    pos = torch.arange(70, dtype=torch.int32)[None]
    lg, _ = m.prefill(p, torch.from_numpy(toks), pos, m.init_cache(1, 96))
    np.testing.assert_allclose(lg.numpy(), reference_logits(jm, jp, toks),
                               **TOL)


def test_hybrid_ring_buffer_matches_jax():
    """Window 8 < context 40: the attention layer's ring holds
    8 + 4 - 1 = 11 slots and chunked prefill wraps it several times."""
    cfg, jm, jp, m, p = models("recurrentgemma-9b", 2, window=8)
    B, T = 1, 40
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, T))
    full = reference_logits(jm, jp, toks)
    cache = m.init_cache(B, 64, prefill_chunk=4)
    assert cache["k"].shape[2] == 11
    tt = torch.from_numpy(toks)
    pos = torch.arange(T, dtype=torch.int32)[None]
    outs = []
    for s in range(0, T, 4):
        lg, cache = m.prefill(p, tt[:, s:s + 4], pos[:, s:s + 4], cache)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full, **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_paged_equals_contiguous(arch):
    """Prefill then decode with a padded bucket row: the paged layout
    (state slots 3 and 0 of 4, sentinel 4 on the padding row) gives the
    contiguous cache's logits bit for bit, and the padding row leaves the
    sentinel at zero."""
    cfg, _, _, m, p = models(arch, 0)
    rng = np.random.RandomState(0)
    B, T, n_new, bs = 2, 12, 5, 16
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, T)))
    pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
    cache_c = m.init_cache(B + 1, 64)
    rows_c = {k: v[:, :B] if k != "pos" else v[:B] for k, v in cache_c.items()}
    cache_p = m.init_paged_cache(8, bs, n_slots=4)
    tables = torch.tensor([[5, 2, -1, -1], [0, 7, -1, -1], [-1] * 4],
                          dtype=torch.int32)
    slots = torch.tensor([3, 0, 4])
    lg_c, _ = m.prefill(p, toks, pos, rows_c)
    lg_p, _ = m.prefill_paged(p, toks, pos, tables[:B], cache_p,
                              rows=slots[:B])
    torch.testing.assert_close(lg_c, lg_p, rtol=0, atol=0)
    nxt = lg_c[:, -1].argmax(-1)
    for t in range(T, T + n_new):
        tt = torch.cat([nxt, torch.zeros(1, dtype=nxt.dtype)])
        sl = torch.tensor([t, t, -1], dtype=torch.int32)
        lg_c, _ = m.decode_step(p, tt, sl, cache_c)
        lg_p, _ = m.decode_step_paged(p, tt, sl, tables, cache_p, rows=slots)
        torch.testing.assert_close(lg_c[:B], lg_p[:B], rtol=0, atol=0)
        nxt = lg_c[:B].argmax(-1)
    for k in ("conv", "ssm", "rec"):
        if k in cache_p:
            assert not bool(cache_p[k][:, 4].any()), k


def test_bf16_tree_keeps_fp32_leaves():
    """The SSM and RG-LRU constants stay fp32 when a bf16 JAX tree is
    converted to bf16; every other float leaf takes the working dtype."""
    for arch in FAMILIES:
        jm = jax_build(jax_config(arch, "reduced"), dtype=jnp.bfloat16)
        tree = jax.device_get(jm.init(jax.random.PRNGKey(0)))
        p = from_jax_params(tree, dtype=torch.bfloat16)
        ours = build_model(get_config(arch, "reduced"), torch.bfloat16,
                           "cpu").init(0)

        def dtypes(t, prefix=""):
            out = {}
            for k, v in t.items():
                if isinstance(v, dict):
                    out.update(dtypes(v, prefix + k + "."))
                else:
                    out[prefix + k] = (str(v.dtype) if hasattr(v, "dtype")
                                       else None)
            return out

        got, want, init = dtypes(p), dtypes(tree), dtypes(ours)
        assert set(got) == set(want) == set(init)
        for k in got:
            fp32 = want[k] == "float32"
            assert (got[k] == "torch.float32") == fp32, k
            assert init[k] == got[k], k
