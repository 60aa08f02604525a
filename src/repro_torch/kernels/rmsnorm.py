"""Fused RMSNorm for Hopper in Triton: `x * rsqrt(mean(x^2) + eps) * (1 + w)`
in fp32, stored in x's dtype. It replaces the Pallas kernel `rmsnorm_kernel`
of the JAX package; `ref.rmsnorm_ref` is its plain version.

Bound: device-memory bytes. The work is one row reduction plus an
elementwise scale, so the kernel reads each row once and writes it once;
one program per row holds the whole row (BLOCK = next power of two >= d)
in registers. There are no tensor cores to reach and no shared-memory
pipeline to build, which is why Triton serves as well as CUDA here.

`triton` is imported on the first launch, never when this module is
imported: the module must import on machines without it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

tl = None      # triton.language, bound on the first launch (see _kernel)
_KERNEL = None


def _rmsnorm_rows(X, W, Y, D, eps, BLOCK: "tl.constexpr"):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < D
    x = tl.load(X + row * D + cols, mask=mask, other=0.0).to(tl.float32)
    w = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
    ms = tl.sum(x * x, axis=0) / D
    y = x * tl.rsqrt(ms + eps) * (1.0 + w)
    tl.store(Y + row * D + cols, y.to(Y.dtype.element_ty), mask=mask)


def _kernel():
    """JIT-wrap `_rmsnorm_rows` on first use. Its body resolves `tl` through
    this module's globals, which Triton reads when it compiles."""
    global tl, _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language as tl
        _KERNEL = triton.jit(_rmsnorm_rows)
    return _KERNEL


def rmsnorm_cuda(x, w, *, eps: float = 1e-6):
    """x: (..., d) CUDA tensor; w: (d,). Returns rms_norm(x) * (1 + w)."""
    d = x.shape[-1]
    _build.require(tuple(w.shape) == (d,), f"weight {tuple(w.shape)} != ({d},)")
    x2 = x.reshape(-1, d).contiguous()
    _build.cuda_args(x2, w)
    out = torch.empty_like(x2)
    block = 1 << (d - 1).bit_length()
    _kernel()[(x2.shape[0],)](x2, w, out, d, eps, BLOCK=block,
                              num_warps=8 if block >= 2048 else 4)
    return out.reshape(x.shape)
