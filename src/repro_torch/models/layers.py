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


WriteIndex = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def cache_write_index(positions, S: int) -> WriteIndex:
    """(row, token, slot) of every real token of a chunk in a contiguous
    cache of S physical slots: slot = pos % S (the ring slot). Padding
    tokens (pos < 0) are left out, so they never write the cache."""
    rows, toks = (positions >= 0).nonzero(as_tuple=True)
    return rows, toks, positions[rows, toks] % S


def paged_write_index(positions, tables, block_size: int) -> WriteIndex:
    """(row, token, flat pool slot) of every real token of a chunk in the
    paged pools: block tables[b, pos // bs], offset pos % bs (DESIGN §9).
    Padding tokens and tokens whose block is unallocated are left out."""
    MB = tables.shape[1]
    blk = (positions // block_size).clamp(0, MB - 1)
    phys = tables.gather(1, blk.to(torch.int64))
    rows, toks = ((positions >= 0) & (phys >= 0)).nonzero(as_tuple=True)
    flat = phys[rows, toks] * block_size + positions[rows, toks] % block_size
    return rows, toks, flat


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
    rows, toks, slots = widx
    cache_k[rows, slots] = k[rows, toks]
    cache_v[rows, slots] = v[rows, toks]
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
    rows, toks, flat = widx
    _pool_write(pool_k, flat, k[rows, toks])
    _pool_write(pool_v, flat, v[rows, toks])
    if T == 1:
        out = ops.paged_decode_attention(q[:, 0], pool_k, pool_v,
                                         positions[:, 0], pool_pos, tables,
                                         window=window).reshape(B, 1, -1)
    else:
        out = ops.paged_flash_attention(q, pool_k, pool_v, positions,
                                        pool_pos, tables, window=window,
                                        causal=True).reshape(B, T, -1)
    return out @ p["wo"]
