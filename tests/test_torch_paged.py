"""The port's paged attention walk and fused residual-add RMSNorm on the CPU,
against the JAX package.

* `split.paged_slots`, the Python mirror of the tensor-core kernel's
  block-table walk (logical slot -> physical slot or -1), against the
  gather `ref.paged_view` that the plain versions use;
* `ref.paged_flash_attention_ref` (the paged chunk's plain version)
  against the JAX package's `paged_view` + `attend`
  (`src/repro/models/layers.py`);
* `ops.add_rmsnorm` against JAX `x + y` then `rms_norm`;
* how many fused and plain norms one forward of each family takes.

The kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py). Inputs come from a numpy seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.config.base import ArchFamily
from repro_torch.config.registry import get_config
from repro_torch.kernels import ops, ref, split
from repro_torch.models.model import build_model
from test_torch_cuda import _paged_pools


@pytest.mark.parametrize("bs", [8, 16, 32])
def test_paged_slots_walk_matches_paged_view(bs):
    """Shuffled physical ids, -1 holes in the middle of a table and at its
    tail: gathering the pools through the walk gives `ref.paged_view`
    exactly, and every slot of a -1 entry walks to -1."""
    rng = np.random.RandomState(0)
    lens = [200, 77, 5]
    MB = -(-max(lens) // bs) + 2
    kp, vp, kpos, tables = _paged_pools(rng, lens, bs, MB, 2, 16,
                                        holes={(0, 2), (1, 1)})
    kp, vp = torch.from_numpy(kp).float(), torch.from_numpy(vp).float()
    kpos, tables = torch.from_numpy(kpos), torch.from_numpy(tables)
    slots = split.paged_slots(tables, bs)
    assert slots.shape == (3, MB * bs)
    dead = (tables < 0).repeat_interleave(bs, dim=1)
    assert bool((slots[dead] == -1).all()) and bool((slots[~dead] >= 0).all())
    ok = slots >= 0
    idx = slots.clamp_min(0)
    k = torch.where(ok[..., None, None], kp.reshape(-1, 2, 16)[idx], 0.0)
    v = torch.where(ok[..., None, None], vp.reshape(-1, 2, 16)[idx], 0.0)
    kp_walk = torch.where(ok, kpos.reshape(-1)[idx], -1)
    kw, vw, kposw = ref.paged_view(kp, vp, kpos, tables)
    assert torch.equal(k, kw) and torch.equal(v, vw)
    assert torch.equal(kp_walk, kposw)
    # a token at position p sits at logical slot p
    for b, n in enumerate(lens):
        vis = kposw[b] >= 0
        assert torch.equal(kposw[b][vis],
                           torch.arange(MB * bs, dtype=torch.int32)[vis])


@pytest.mark.parametrize("window", [0, 300])
def test_paged_flash_plain_matches_jax(window):
    """Chunks of 16 queries through the block tables (blocks of 16, a hole
    in one table) against JAX `paged_view` + `attend`, fp32, on the rows
    with a visible key."""
    rng = np.random.RandomState(1)
    Tq, H, KV, hd, bs = 16, 4, 2, 16, 16
    lens = [600, 250, 16]
    MB = 40
    kp, vp, kpos, tables = _paged_pools(rng, lens, bs, MB, KV, hd,
                                        holes={(1, 2)})
    qp = np.stack([np.arange(n - Tq, n) for n in lens]).astype(np.int32)
    q = rng.randn(len(lens), Tq, H, hd).astype(np.float32)
    kp, vp = kp.astype(np.float32), vp.astype(np.float32)
    got = ops.paged_flash_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, qp, kpos, tables)),
        window=window).reshape(len(lens), Tq, H * hd)
    kv, vv, kposv = jlayers.paged_view(jnp.asarray(kp), jnp.asarray(vp),
                                       jnp.asarray(kpos), jnp.asarray(tables))
    want = jlayers.attend(jnp.asarray(q), kv, vv, jnp.asarray(qp), kposv,
                          window=window, causal=True)
    kposv = np.asarray(kposv)
    vis = ((kposv[:, None, :] >= 0) & (kposv[:, None, :] <= qp[:, :, None])
           & ((window == 0) | (kposv[:, None, :] > qp[:, :, None] - window)))
    rows = vis.any(-1)
    assert rows.sum() > 0
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rmsnorm_plain_matches_jax(dtype):
    """The sum is bit for bit JAX's `x + y` in the working dtype; the norm
    of it is within 2e-4 of JAX's `rms_norm` in fp32 (and within bf16
    rounding in bf16)."""
    rng = np.random.RandomState(2)
    x, y = rng.randn(2, 6, 3, 96).astype(np.float32)
    w = (rng.randn(96) * 0.1).astype(np.float32)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    s, h = ops.add_rmsnorm(*(torch.from_numpy(a).to(tdt) for a in (x, y, w)))
    jx, jy, jw = (jnp.asarray(a).astype(jdt) for a in (x, y, w))
    js = jx + jy
    jh = jlayers.rms_norm(js, jw, 1e-6)
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    tol = 2e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(h.float().numpy(),
                               np.asarray(jh.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def _norms_per_forward(cfg):
    """(fused add + RMSNorm, plain RMSNorm) launches of one forward: every
    residual add a norm reads next is fused into it (a layer's ln1 and
    ln2, the final ln_f); the model's first norm and mamba2's gated norm
    stay plain."""
    L = cfg.num_layers
    if cfg.family == ArchFamily.SSM:
        return L, L + 1
    return 2 * L, 1


@pytest.mark.parametrize("arch,full", [("granite-3-8b", (80, 1)),
                                       ("mamba2-2.7b", (64, 65)),
                                       ("recurrentgemma-9b", (76, 1))])
def test_norm_launches_per_forward(monkeypatch, arch, full):
    """A CPU forward of the reduced config (prefill, then a decode step;
    contiguous and paged) calls the fused and the plain norm as often as
    the kernels launch on the card, and at full depth that is the
    families' 80 + 1, 64 + 65 and 76 + 1."""
    assert _norms_per_forward(get_config(arch, "full")) == full
    counts = {"add_rmsnorm": 0, "rmsnorm": 0}
    for name in counts:
        def counted(*a, _f=getattr(ops, name), _n=name, **k):
            counts[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    cfg = get_config(arch, "reduced")
    m = build_model(cfg, torch.float32, "cpu")
    p = m.init(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(0))
    pos = torch.arange(9, dtype=torch.int32)[None].repeat(2, 1)
    tables = torch.tensor([[0, 1], [3, 2]], dtype=torch.int32)
    rows = torch.tensor([0, 1])
    forwards = [
        lambda c: m.prefill(p, toks[:, :8], pos[:, :8], c),
        lambda c: m.decode_step(p, toks[:, 8], pos[:, 8], c),
        lambda c: m.prefill_paged(p, toks[:, :8], pos[:, :8], tables, c,
                                  rows=rows),
        lambda c: m.decode_step_paged(p, toks[:, 8], pos[:, 8], tables, c,
                                      rows=rows)]
    caches = [m.init_cache(2, 16, prefill_chunk=8),
              m.init_paged_cache(4, 8, n_slots=2)]
    for i, fwd in enumerate(forwards):
        cache = caches[i // 2]
        before = dict(counts)
        _, caches[i // 2] = fwd(cache)
        got = (counts["add_rmsnorm"] - before["add_rmsnorm"],
               counts["rmsnorm"] - before["rmsnorm"])
        assert got == _norms_per_forward(cfg), (i, got)
