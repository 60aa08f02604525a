"""Transformer layers: seeded parameter init, RMSNorm, RoPE, GQA attention
through a contiguous (possibly ring) or paged KV cache, SwiGLU MLP.

Conventions (those of the JAX package's `models/layers.py`):

* params are nested dicts of tensors in `x @ w` orientation;
* norms and softmax accumulate in fp32;
* caches store the absolute position of every physical slot (-1 = empty),
  so masking is position arithmetic and RoPE is applied at absolute
  positions before the write, which makes ring wrap-around transparent.

Attention and RMSNorm go through `kernels.ops`: the Hopper kernels for CUDA
tensors, their plain versions for CPU tensors. The projections stay
`torch.matmul`. Caches are updated in place.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops


class ParamInit:
    """Seeded random weights with the JAX package's scales, drawn in place
    in the working dtype on the target device (one layer at a time, so peak
    memory stays at the weights themselves). The numbers differ from the
    JAX package's for the same seed; the distributions are the same."""

    def __init__(self, seed: int, dtype: torch.dtype, device):
        self.dtype, self.device = dtype, device
        self.g = torch.Generator(device=device).manual_seed(seed)

    def normal(self, shape, scale: float):
        return torch.empty(shape, dtype=self.dtype, device=self.device
                           ).normal_(0.0, scale, generator=self.g)

    def stacked(self, n: int, shape, scale: Optional[float] = None):
        """n layers of `shape`, each normal / sqrt(fan_in = shape[0]) unless
        `scale` is given."""
        w = torch.empty((n,) + tuple(shape), dtype=self.dtype,
                        device=self.device)
        for i in range(n):
            w[i].normal_(0.0, scale if scale is not None
                         else 1 / math.sqrt(shape[0]), generator=self.g)
        return w

    def uniform(self, shape, lo: float, hi: float):
        """fp32 uniform draws in [lo, hi)."""
        return torch.empty(shape, dtype=torch.float32, device=self.device
                           ).uniform_(lo, hi, generator=self.g)

    def zeros(self, *shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or self.dtype,
                           device=self.device)


def init_attention(init: ParamInit, cfg: ModelConfig, n: int):
    """n stacked GQA attention blocks: wq/wk/wv at 1/sqrt(d), wo at
    0.02/sqrt(2 L), zero biases where the config has them."""
    d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {"wq": init.stacked(n, (d, H * hd)),
         "wk": init.stacked(n, (d, KV * hd)),
         "wv": init.stacked(n, (d, KV * hd)),
         "wo": init.stacked(n, (H * hd, d), out_scale(cfg))}
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = init.zeros(n, width)
    return p


def init_mlp(init: ParamInit, cfg: ModelConfig, n: int):
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": init.stacked(n, (d, f)), "w_up": init.stacked(n, (d, f)),
            "w_down": init.stacked(n, (f, d), out_scale(cfg))}


def out_scale(cfg: ModelConfig) -> float:
    """Scale of every projection back into the residual stream."""
    return 0.02 / math.sqrt(2 * max(cfg.num_layers, 1))


def rms_norm(x, w, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * (1 + w) — the RMSNorm kernel."""
    return ops.rmsnorm(x, w, eps=eps)


def add_rms_norm(x, y, w, eps: float = 1e-6):
    """(x + y, rms_norm(x + y)) — the residual add fused into the RMSNorm
    kernel that reads it; the sum is bit for bit `x + y`."""
    return ops.add_rmsnorm(x, y, w, eps=eps)


def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x: (B, T, H, hd); positions: (B, T). Rotates half-splits (not
    interleaved pairs), in fp32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs          # (B, T, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def attend(q, k, v, q_pos, k_pos, *, window: int = 0):
    """Causal GQA attention of new queries over cache keys.

    q: (B, T, H, hd); k/v: (B, S, KV, hd); q_pos: (B, T); k_pos: (B, S).
    One query per row (decode) takes the flash-decode kernel, a chunk
    (T > 1) the flash-attention kernel. Returns (B, T, H*hd)."""
    B, T, H, hd = q.shape
    if T == 1:
        out = ops.decode_attention(q[:, 0], k, v, q_pos[:, 0], k_pos,
                                   window=window)
    else:
        out = ops.flash_attention(q, k, v, q_pos, k_pos, window=window,
                                  causal=True)
    return out.reshape(B, T, H * hd)


def attention_qkv(p, x, cfg: ModelConfig):
    B, T, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, T, H, hd), k.reshape(B, T, KV, hd),
            v.reshape(B, T, KV, hd))


def mlp(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


#: a write index: (B, T) tensors of one fixed shape per chunk shape, built
#: on the device with no host sync, so a step that uses it can be captured
#: in a CUDA graph. Contiguous: (rows, slots, real); paged: (flat, real).
WriteIndex = Tuple[torch.Tensor, ...]

_NO_REAL = -(1 << 30)


def cache_write_index(positions, S: int) -> WriteIndex:
    """(row, slot, real) of every token of a chunk in a contiguous cache of
    S physical slots, each (B, T). A real token (pos >= 0) targets slot
    pos % S (the ring slot). A padding token targets the slot its row's
    positions would give it if they ran on through the chunk (row start +
    t, mod S; an all-padding row starts at 0), and `cache_put` writes that
    slot's own value back to it. A row's real tokens sit at consecutive
    positions (a prefill chunk, a decode token), so with T <= S the row's
    T targets are distinct: no call writes one slot twice."""
    B, T = positions.shape
    if T > S:
        raise ValueError(f"a chunk of {T} tokens does not fit a cache row "
                         f"of {S} slots")
    t = torch.arange(T, dtype=positions.dtype, device=positions.device)
    real = positions >= 0
    start = torch.where(real, positions - t, _NO_REAL).amax(1, keepdim=True)
    start = torch.where(start == _NO_REAL, 0, start)
    slots = torch.where(real, positions, start + t) % S
    rows = torch.arange(B, device=positions.device)[:, None].expand(B, T)
    return rows, slots.to(torch.int64), real


def cache_put(cache_x, widx: WriteIndex, val) -> None:
    """cache_x[b, slot] = val[b, t] at every real token of `widx`
    (`cache_write_index`), in place; a padding token writes its target
    slot's own value back, so no visible slot changes. val: (B, T, ...)."""
    rows, slots, real = widx
    keep = real.view(real.shape + (1,) * (val.dim() - 2))
    cache_x[rows, slots] = torch.where(keep, val.to(cache_x.dtype),
                                       cache_x[rows, slots])


def paged_write_index(positions, tables, block_size: int,
                      spare: int) -> WriteIndex:
    """(flat pool slot, real) of every token of a chunk in the paged pools,
    each (B, T): block tables[b, pos // bs], offset pos % bs (DESIGN §9).
    Padding tokens and tokens whose block is unallocated target the first
    slot of block `spare`, which no table names (`init_paged_cache` keeps
    it past the allocator's blocks); they store position -1 there."""
    MB = tables.shape[1]
    blk = (positions // block_size).clamp(0, MB - 1)
    phys = tables.gather(1, blk.to(torch.int64)).to(torch.int64)
    real = (positions >= 0) & (phys >= 0)
    flat = torch.where(real, phys * block_size + positions % block_size,
                       spare * block_size)
    return flat, real


def self_attention_cached(p, x, positions, cache_k, cache_v, cache_pos,
                          widx: WriteIndex, cfg: ModelConfig, *,
                          window: int = 0):
    """Self-attention through a contiguous (possibly ring) KV cache.

    x: (B, T, d) new tokens at absolute `positions` (B, T); cache_k/v:
    (B, S, KV, hd), written in place at `widx` (`cache_write_index`);
    cache_pos: (B, S), already holding this chunk's positions."""
    q, k, v = attention_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    cache_put(cache_k, widx, k)
    cache_put(cache_v, widx, v)
    out = attend(q, cache_k, cache_v, positions, cache_pos, window=window)
    return out @ p["wo"]


def _pool_write(pool, flat_slots, val):
    """Write per-token values into a paged pool (NB, bs, ...) at flat slot
    indices into NB*bs, in place."""
    NB, bs = pool.shape[:2]
    pool.view((NB * bs,) + pool.shape[2:])[flat_slots] = val


def self_attention_paged(p, x, positions, pool_k, pool_v, pool_pos, tables,
                         widx: WriteIndex, cfg: ModelConfig, *,
                         window: int = 0):
    """Self-attention through the physically paged KV pool (DESIGN §9).

    pool_k/v: (NB, bs, KV, hd), written in place at `widx`
    (`paged_write_index`); pool_pos: (NB, bs), already holding this chunk's
    positions; tables: (B, MB) physical block ids (-1 = unallocated).
    Decode and chunks both walk the block table in the kernels (paged
    flash decode, paged flash attention); nothing is gathered first."""
    B, T, _ = x.shape
    q, k, v = attention_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    flat, _ = widx
    _pool_write(pool_k, flat, k)
    _pool_write(pool_v, flat, v)
    if T == 1:
        out = ops.paged_decode_attention(q[:, 0], pool_k, pool_v,
                                         positions[:, 0], pool_pos, tables,
                                         window=window).reshape(B, 1, -1)
    else:
        out = ops.paged_flash_attention(q, pool_k, pool_v, positions,
                                        pool_pos, tables, window=window,
                                        causal=True).reshape(B, T, -1)
    return out @ p["wo"]
