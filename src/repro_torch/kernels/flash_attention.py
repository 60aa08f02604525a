"""Launchers of the hand-written Hopper flash-attention kernel
(`csrc/flash_attention.cu`), the prefill attention of the serving path,
over a contiguous cache row or through the paged pools and a block table.
They replace the Pallas kernel `flash_attention_kernel` of the JAX
package; `ref.flash_attention_ref` / `ref.paged_flash_attention_ref` are
their plain versions. Ragged Tq/Tk tails are masked in the kernel, so
chunks of any length go through unpadded. CUDA tensors only: `ops`
dispatches CPU tensors to the plain versions.

Two bf16 designs, picked per call by `split.route` (dtype, head_dim,
packed rows M = Tq * G, Tk, block size):
* a serving chunk (16 tokens against a 1k-slot row, M = 16 G) is small
  work, bound by the visible keys' K/V bytes and by latency: the mma.sync
  kernel of `csrc/attention_mma.cuh`, rows (token, head in group) pairs of
  one kv head, token-major, so K/V are read once for all G heads; cp.async
  tiles one ahead of the one in use; a tile no row can see is skipped; the
  key axis split across blocks when the grid is under half a wave
  (`split.num_splits`, the combine pass that decode shares); paged, the
  same kernel walks the block table (`split.paged_slots`);
* a call of at least `split.WGMMA_MIN_ROWS` packed rows at head_dim 64 or
  128 (the seamless encoder, long prefill chunks) is bound by operations:
  the long-row kernel of `csrc/flash_wgmma.cuh`, 128 rows a block, K/V by
  TMA into a ring of stages from tensor maps encoded here each call (on the
  host, in the C entry), two consumer warpgroups on wgmma; paged, its
  producer reads the block table.
fp32 runs the CUDA-core fp32 kernel. `_kernel` names the kernel instead
of the route: `ops` passes the route it counts launches by, and the
kernels phase of `chip_smoke.py` times "mma" and "wgmma" on the same
calls; a call the named kernel cannot run raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref, split

HEAD_DIMS = (32, 64, 128, 256)


def _kernel_for(q, hd: int, rows: int, Tk: int, kernel: Optional[str],
                block_size: Optional[int] = None) -> str:
    """The routed kernel, or the named one ("fp32", "mma", "wgmma") after
    checking that it takes the call."""
    if kernel is None:
        return split.route(q.dtype, hd, rows, Tk, block_size)
    bf16 = q.dtype == torch.bfloat16
    if not (kernel == "fp32" and not bf16 or kernel == "mma" and bf16
            or kernel == "wgmma"
            and split.wgmma_takes(q.dtype, hd, Tk, block_size)):
        raise ValueError(f"flash_attention: kernel {kernel!r} does not take "
                         f"{q.dtype} hd={hd} Tk={Tk} block_size="
                         f"{block_size}")
    return kernel


def flash_attention_cuda(q, k, v, q_pos, k_pos, *, window: int = 0,
                         causal: bool = True, _kernel: Optional[str] = None):
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
    kernel = _kernel_for(q, hd, Tq * (H // KV), Tk, _kernel)
    n_splits, scratch = split.plan(q, B, KV, Tq * (H // KV), Tk, hd,
                                   B * Tq * H, kernel=kernel)
    lib = _build.library("flash_attention")
    _build.check(lib.flash_attention(
        _build.DTYPE_CODE[q.dtype], split.KERNEL_CODE[kernel], *ptrs,
        *split.pointers(scratch), B, Tq, Tk, H, KV, hd, window, int(causal),
        n_splits, _build.stream()), f"flash_attention ({kernel})")
    return out


def paged_flash_attention_cuda(q, k_pool, v_pool, q_pos, kpos_pool, tables,
                               *, window: int = 0, causal: bool = True,
                               _kernel: Optional[str] = None):
    """q: (B, Tq, H, hd); k/v_pool: (NB, bs, KV, hd); q_pos: (B, Tq);
    kpos_pool: (NB, bs); tables: (B, MB), -1 = unallocated. Returns
    (B, Tq, H, hd).

    bf16 (the serving dtype) walks the block table in the routed
    tensor-core kernel. fp32 (the on-card model tests) is routed by its dtype to the
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
                                    causal=causal, _kernel=_kernel)
    q_pos = q_pos.to(torch.int32).contiguous()
    kpos_pool = kpos_pool.to(torch.int32).contiguous()
    tables = tables.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    ptrs = _build.cuda_args(q, k_pool, v_pool, dtype=q.dtype) \
        + _build.cuda_args(q_pos, kpos_pool, tables, out)
    kernel = _kernel_for(q, hd, Tq * (H // KV), MB * bs, _kernel, bs)
    n_splits, scratch = split.plan(q, B, KV, Tq * (H // KV), MB * bs, hd,
                                   B * Tq * H, kernel=kernel)
    lib = _build.library("flash_attention")
    _build.check(lib.paged_flash_attention(
        split.KERNEL_CODE[kernel], *ptrs, *split.pointers(scratch), B, Tq, H,
        KV, hd, NB, bs, MB, window, int(causal), n_splits, _build.stream()),
        f"paged_flash_attention ({kernel})")
    return out
