"""Launchers of the hand-written Hopper flash-decode kernels
(`csrc/decode_attention.cu`): one query token per request against a
contiguous (B, S, KV, hd) cache row or through the paged (NB, bs, KV, hd)
pools and a (B, MB) block table. They replace the Pallas kernels
`decode_attention_kernel` and `paged_decode_attention_kernel` of the JAX
package; `ref.decode_attention_ref` / `ref.paged_decode_attention_ref` are
their plain versions. CUDA tensors only: `ops` dispatches CPU tensors to
the plain versions.

Both are bound by the bytes of K and V. In bf16 (the serving dtype) both
run the tensor-core kernel of `csrc/attention_mma.cuh` as its Tq = 1 case:
the G query heads of a kv head are packed as mma rows, so K/V are read
once for all of them, in bf16 tiles loaded with cp.async two ahead of the
one in use; a tile whose slots are all invisible is skipped after reading
its k_pos; and the key axis is split across blocks when the (B, KV) grid
is under half a wave, with the count from `split.num_splits` and the
combine pass that the prefill kernel shares. Paged, the kernel walks the
block table (`split.paged_slots` is its walk, written out): each key row
of a tile is read from its own physical slot, so any block size works.
fp32 runs the CUDA-core fp32 kernel, one block per (B, KV), whose paged
walk takes one block of at most TILE slots a tile.

A sequence-sharded decode (the cache's slots cut over a data axis) takes
two more launchers: `decode_attention_partial_cuda`, the contiguous decode
over one rank's slots stopped before its normalization (fp32 O and (m, l)
a row; in bf16 every key-axis split writes its partials and the combine
pass folds them without normalizing), and `attention_combine_cuda`, which
merges the ranks' gathered partials through the same combine pass. `ref.decode_attention_partial_ref` and
`ref.attention_combine_ref` are their plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, split

#: slots per tile of the fp32 kernel, and the largest paged block it takes
TILE = 64
HEAD_DIMS = (16, 32, 64, 128, 256)


def _check_q(q, KV, hd):
    B, H, qhd = q.shape
    _build.require(q.dtype in _build.DTYPE_CODE, f"unsupported dtype {q.dtype}")
    _build.require(qhd == hd and H % KV == 0,
                   f"q {tuple(q.shape)} does not match kv heads {KV} x {hd}")
    _build.require(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    # the kernel's accumulators: 16 per thread, 32 at head_dim 256
    max_gd = 4096 if hd == 256 else 2048
    _build.require((H // KV) * hd <= max_gd,
                   f"G * head_dim must be <= {max_gd} at head_dim {hd}")
    return B, H


def decode_attention_cuda(q, k, v, q_pos, k_pos, *, window: int = 0):
    """q: (B, H, hd); k/v: (B, S, KV, hd); q_pos: (B,); k_pos: (B, S)."""
    _, S, KV, hd = k.shape
    B, H = _check_q(q, KV, hd)
    _build.require(k.shape == v.shape and k.shape[0] == B
                   and tuple(k_pos.shape) == (B, S) and q_pos.shape == (B,),
                   "decode_attention: inconsistent shapes")
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    ptrs = _build.cuda_args(q, k, v, dtype=q.dtype) \
        + _build.cuda_args(q_pos, k_pos, out)
    n_splits, scratch = split.plan(q, B, KV, H // KV, S, hd, B * H)
    lib = _build.library("decode_attention")
    _build.check(lib.decode_attention(
        _build.DTYPE_CODE[q.dtype], *ptrs, *split.pointers(scratch), B, H,
        KV, hd, S, window, n_splits, _build.stream()), "decode_attention")
    return out


def decode_attention_partial_cuda(q, k, v, q_pos, k_pos, *, window: int = 0):
    """q: (B, H, hd); k/v: (B, S, KV, hd) a rank's slots; q_pos: (B,);
    k_pos: (B, S) -> fp32 (o (B, H, hd), ml (B, H, 2))."""
    _, S, KV, hd = k.shape
    B, H = _check_q(q, KV, hd)
    _build.require(k.shape == v.shape and k.shape[0] == B
                   and tuple(k_pos.shape) == (B, S) and q_pos.shape == (B,),
                   "decode_attention_partial: inconsistent shapes")
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    o = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    ml = torch.empty((B, H, 2), dtype=torch.float32, device=q.device)
    ptrs = _build.cuda_args(q, k, v, dtype=q.dtype) \
        + _build.cuda_args(q_pos, k_pos, o, ml)
    n_splits, scratch = split.plan(q, B, KV, H // KV, S, hd, B * H,
                                   partial=True)
    lib = _build.library("decode_attention")
    _build.check(lib.decode_attention_partial(
        _build.DTYPE_CODE[q.dtype], *ptrs, *split.pointers(scratch), B, H,
        KV, hd, S, window, n_splits, _build.stream()),
        "decode_attention_partial")
    return o, ml


def attention_combine_cuda(o, ml, *, dtype=torch.float32):
    """o: (R, B, H, hd), ml: (R, B, H, 2), fp32 -> (B, H, hd) in
    `dtype`."""
    R, B, H, hd = o.shape
    _build.require(o.dtype == ml.dtype == torch.float32
                   and tuple(ml.shape) == (R, B, H, 2)
                   and dtype in _build.DTYPE_CODE and hd % 4 == 0,
                   "attention_combine: inconsistent shapes or dtypes")
    o, ml = o.contiguous(), ml.contiguous()
    out = torch.empty((B, H, hd), dtype=dtype, device=o.device)
    lib = _build.library("decode_attention")
    _build.check(lib.attention_combine(
        _build.DTYPE_CODE[dtype], *_build.cuda_args(o, ml, out), R, B * H,
        hd, _build.stream()), "attention_combine")
    return out


def paged_decode_attention_cuda(q, k_pool, v_pool, q_pos, kpos_pool, tables,
                                *, window: int = 0):
    """q: (B, H, hd); k/v_pool: (NB, bs, KV, hd); q_pos: (B,);
    kpos_pool: (NB, bs); tables: (B, MB), -1 = unallocated."""
    NB, bs, KV, hd = k_pool.shape
    B, H = _check_q(q, KV, hd)
    MB = tables.shape[1]
    _build.require(k_pool.shape == v_pool.shape
                   and tuple(kpos_pool.shape) == (NB, bs)
                   and tables.shape[0] == B and q_pos.shape == (B,),
                   "paged_decode_attention: inconsistent shapes")
    _build.require(q.dtype == torch.bfloat16 or bs <= TILE,
                   f"fp32 paged decode: block_size {bs} > {TILE}")
    q_pos = q_pos.to(torch.int32).contiguous()
    kpos_pool = kpos_pool.to(torch.int32).contiguous()
    tables = tables.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    ptrs = _build.cuda_args(q, k_pool, v_pool, dtype=q.dtype) \
        + _build.cuda_args(q_pos, kpos_pool, tables, out)
    n_splits, scratch = split.plan(q, B, KV, H // KV, MB * bs, hd, B * H)
    lib = _build.library("decode_attention")
    _build.check(lib.paged_decode_attention(
        _build.DTYPE_CODE[q.dtype], *ptrs, *split.pointers(scratch), B, H,
        KV, hd, bs, MB, window, n_splits, _build.stream()),
        "paged_decode_attention")
    return out
