"""Launchers of the hand-written Hopper flash-attention kernel
(`csrc/flash_attention.cu`), the prefill attention of the serving path,
over a contiguous cache row or through the paged pools and a block table.
They replace the Pallas kernel `flash_attention_kernel` of the JAX
package; `ref.flash_attention_ref` / `ref.paged_flash_attention_ref` are
their plain versions. Ragged Tq/Tk tails are masked in the kernel, so
chunks of any length go through unpadded. CUDA tensors only: `ops`
dispatches CPU tensors to the plain versions.

A serving chunk (16 tokens against a 1k-slot row) is small work, bound by
the visible keys' K/V bytes and by latency. bf16 (the serving dtype) runs
the tensor-core kernel of `csrc/attention_mma.cuh`: rows are (token, head
in group) pairs of one kv head, token-major, so K/V are read once for all
G heads; S and P V are mma.sync products from bf16 tiles loaded with
cp.async one ahead of the one in use; a tile no row can see is skipped;
and the key axis is split across blocks when the grid is under half a
wave, with the count from `split.num_splits` and the combine pass that
decode shares. A paged chunk in bf16 runs the same kernel through the
block table (the walk of `split.paged_slots`), so no per-request view of
the pools is gathered. fp32 runs the CUDA-core fp32 kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref, split

HEAD_DIMS = (32, 64, 128, 256)


def flash_attention_cuda(q, k, v, q_pos, k_pos, *, window: int = 0,
                         causal: bool = True):
    """q: (B, Tq, H, hd); k/v: (B, Tk, KV, hd); q_pos: (B, Tq);
    k_pos: (B, Tk). Returns (B, Tq, H, hd)."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    _build.require(q.dtype in _build.DTYPE_CODE, f"unsupported dtype {q.dtype}")
    _build.require(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    _build.require(k.shape == v.shape and tuple(k.shape) == (B, Tk, KV, hd)
                   and H % KV == 0 and tuple(q_pos.shape) == (B, Tq)
                   and tuple(k_pos.shape) == (B, Tk),
                   "flash_attention: inconsistent shapes")
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    ptrs = _build.cuda_args(q, k, v, dtype=q.dtype) \
        + _build.cuda_args(q_pos, k_pos, out)
    n_splits, scratch = split.plan(q, B, KV, Tq * (H // KV), Tk, hd,
                                   B * Tq * H)
    lib = _build.library("flash_attention")
    _build.check(lib.flash_attention(
        _build.DTYPE_CODE[q.dtype], *ptrs, *split.pointers(scratch), B, Tq,
        Tk, H, KV, hd, window, int(causal), n_splits, _build.stream()),
        "flash_attention")
    return out


def paged_flash_attention_cuda(q, k_pool, v_pool, q_pos, kpos_pool, tables,
                               *, window: int = 0, causal: bool = True):
    """q: (B, Tq, H, hd); k/v_pool: (NB, bs, KV, hd); q_pos: (B, Tq);
    kpos_pool: (NB, bs); tables: (B, MB), -1 = unallocated. Returns
    (B, Tq, H, hd).

    bf16 (the serving dtype) walks the block table in the tensor-core
    kernel. fp32 (the on-card model tests) is routed by its dtype to the
    fp32 CUDA-core kernel over the gathered per-request view
    (`ref.paged_view`), which that kernel reads contiguously."""
    B, Tq, H, hd = q.shape
    NB, bs, KV = k_pool.shape[:3]
    MB = tables.shape[1]
    _build.require(q.dtype in _build.DTYPE_CODE, f"unsupported dtype {q.dtype}")
    _build.require(hd in HEAD_DIMS, f"head_dim {hd} not in {HEAD_DIMS}")
    _build.require(k_pool.shape == v_pool.shape
                   and tuple(k_pool.shape) == (NB, bs, KV, hd)
                   and H % KV == 0 and tuple(q_pos.shape) == (B, Tq)
                   and tuple(kpos_pool.shape) == (NB, bs)
                   and tables.shape[0] == B,
                   "paged_flash_attention: inconsistent shapes")
    if q.dtype == torch.float32:
        k, v, k_pos = ref.paged_view(k_pool, v_pool, kpos_pool, tables)
        return flash_attention_cuda(q, k, v, q_pos, k_pos, window=window,
                                    causal=causal)
    q_pos = q_pos.to(torch.int32).contiguous()
    kpos_pool = kpos_pool.to(torch.int32).contiguous()
    tables = tables.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    ptrs = _build.cuda_args(q, k_pool, v_pool, dtype=q.dtype) \
        + _build.cuda_args(q_pos, kpos_pool, tables, out)
    n_splits, scratch = split.plan(q, B, KV, Tq * (H // KV), MB * bs, hd,
                                   B * Tq * H)
    lib = _build.library("flash_attention")
    _build.check(lib.paged_flash_attention(
        *ptrs, *split.pointers(scratch), B, Tq, H, KV, hd, bs, MB, window,
        int(causal), n_splits, _build.stream()), "paged_flash_attention")
    return out
