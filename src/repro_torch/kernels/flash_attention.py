"""Launcher of the hand-written Hopper flash-attention kernel
(`csrc/flash_attention.cu`), the prefill attention of the serving path. It
replaces the Pallas kernel `flash_attention_kernel` of the JAX package;
`ref.flash_attention_ref` is its plain version. Ragged Tq/Tk tails are
masked in the kernel, so chunks of any length go through unpadded. CUDA
tensors only: `ops` dispatches CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

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
    lib = _build.library("flash_attention")
    _build.check(lib.flash_attention(
        _build.DTYPE_CODE[q.dtype], *ptrs, B, Tq, Tk, H, KV, hd, window,
        int(causal), _build.stream()), "flash_attention")
    return out
