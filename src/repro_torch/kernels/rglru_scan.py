"""Launcher of the hand-written Hopper kernel of the RG-LRU linear
recurrence (`csrc/rglru_scan.cu`). It replaces the Pallas kernel
`rglru_scan_kernel` of the JAX package; `ref.rglru_scan_ref` is its plain
version. CUDA tensors only: `ops` dispatches CPU tensors to the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rglru_scan_cuda(a, bx, h0):
    """a/bx: (B, T, W) fp32; h0: (B, W) fp32. Returns (h_all (B, T, W),
    h_T (B, W)) of h_t = a_t h_{t-1} + bx_t."""
    B, T, W = a.shape
    _build.require(bx.shape == a.shape and tuple(h0.shape) == (B, W),
                   "rglru_scan: inconsistent shapes")
    _build.require(all(t.dtype == torch.float32 for t in (a, bx, h0)),
                   "rglru_scan: fp32 operands required")
    y = torch.empty_like(a)
    hT = torch.empty_like(h0)
    ptrs = _build.cuda_args(a, bx, h0, y, hT)
    lib = _build.library("rglru_scan")
    _build.check(lib.rglru_scan(*ptrs, B, T, W, _build.stream()),
                 "rglru_scan")
    return y, hT
