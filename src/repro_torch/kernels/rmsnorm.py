"""Launchers of the hand-written Hopper RMSNorm kernels (`csrc/rmsnorm.cu`):
`x * rsqrt(mean(x^2) + eps) * (1 + w)` in fp32, stored in x's dtype, and
the same norm fused with the residual add before it (`s = x + y` in x's
dtype, then the norm of the rounded `s`). They replace the Pallas kernel
`rmsnorm_kernel` of the JAX package; `ref.rmsnorm_ref` /
`ref.add_rmsnorm_ref` are their plain versions. CUDA tensors only: `ops`
dispatches CPU tensors to the plain versions.

Bound: device-memory bytes, and at a decode step's 8 rows the launch
itself. A block holds whole rows in registers (16-byte loads, all issued
before the reduction), takes the sum of squares by warp shuffles and one
shared-memory step, keeps the weight for all its rows, and the grid is
capped at the SMs' resident blocks. The fused add saves the residual
add's own launch and one read and write of the residual stream.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

THREADS, MAX_LOADS = 256, 8  # a block's threads; loads a thread holds a row


def max_width(element_size: int, d: int) -> int:
    """The widest row the kernel holds: 16-byte loads when d fills them,
    one element a load otherwise."""
    vec = 16 // element_size
    return THREADS * MAX_LOADS * (vec if d % vec == 0 else 1)


def _width(x, w) -> int:
    """d, after the checks. The messages are formatted only on failure:
    the norms launch some 80 times a forward, and the launch is host-bound
    at the decode shape."""
    d = x.shape[-1]
    if (x.dtype not in _build.DTYPE_CODE or w.shape != (d,)
            or w.dtype != x.dtype
            or not 0 < d <= max_width(x.element_size(), d)):
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} {x.dtype}, weight "
                         f"{tuple(w.shape)} {w.dtype}: one dtype (fp32 or "
                         f"bf16), weight (d,), d <= "
                         f"{max_width(x.element_size(), d)}")
    return d


def rmsnorm_cuda(x, w, *, eps: float = 1e-6):
    """x: (..., d) CUDA tensor; w: (d,). Returns rms_norm(x) * (1 + w)."""
    d = _width(x, w)
    x = x.contiguous()
    out = torch.empty_like(x)
    ptrs = _build.cuda_args(x, w, out, dtype=x.dtype)
    _build.check(_build.library("rmsnorm").rmsnorm(
        _build.DTYPE_CODE[x.dtype], *ptrs, x.numel() // d, d, eps,
        _build.stream()), "rmsnorm")
    return out


def add_rmsnorm_cuda(x, y, w, *, eps: float = 1e-6):
    """x, y: (..., d) CUDA tensors of one dtype; w: (d,). Returns
    (s, rms_norm(s) * (1 + w)) with s = x + y in x's dtype."""
    if x.shape != y.shape or x.dtype != y.dtype:
        raise ValueError(f"add_rmsnorm: {tuple(x.shape)} {x.dtype} vs "
                         f"{tuple(y.shape)} {y.dtype}")
    d = _width(x, w)
    x, y = x.contiguous(), y.contiguous()
    s, out = torch.empty_like(x), torch.empty_like(x)
    ptrs = _build.cuda_args(x, y, w, s, out, dtype=x.dtype)
    _build.check(_build.library("rmsnorm").add_rmsnorm(
        _build.DTYPE_CODE[x.dtype], *ptrs, x.numel() // d, d, eps,
        _build.stream()), "add_rmsnorm")
    return s, out
