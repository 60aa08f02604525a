"""Launcher of the hand-written Hopper kernel of the Mamba2 SSD intra-chunk
term (`csrc/ssd_scan.cu`). It replaces the Pallas kernel `ssd_intra_kernel`
of the JAX package; `ref.ssd_intra_ref` is its plain version. CUDA tensors
only: `ops` dispatches CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: the kernel's limits: chunk length, head dim, state dim
MAX_Q, MAX_P, MAX_N = 256, 64, 128


def ssd_intra_cuda(xdt, cum_a, Br, Cr):
    """xdt: (B, nc, Q, H, P); cum_a: (B, nc, Q, H); Br/Cr: (B, nc, Q, N),
    all fp32. Returns y_intra (B, nc, Q, H, P), s_chunk (B, nc, H, P, N)."""
    B, nc, Q, H, P = xdt.shape
    N = Br.shape[-1]
    _build.require(tuple(cum_a.shape) == (B, nc, Q, H)
                   and tuple(Br.shape) == (B, nc, Q, N)
                   and Cr.shape == Br.shape, "ssd_intra: inconsistent shapes")
    _build.require(Q <= MAX_Q and P <= MAX_P and N <= MAX_N,
                   f"ssd_intra: Q {Q} <= {MAX_Q}, P {P} <= {MAX_P} and "
                   f"N {N} <= {MAX_N} required")
    _build.require(all(t.dtype == torch.float32 for t in (xdt, cum_a, Br, Cr)),
                   "ssd_intra: fp32 operands required")
    y = torch.empty_like(xdt)
    s = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=xdt.device)
    cb = torch.empty((B * nc, Q, Q), dtype=torch.float32, device=xdt.device)
    ptrs = _build.cuda_args(xdt, cum_a, Br, Cr, cb, y, s)
    lib = _build.library("ssd_scan")
    _build.check(lib.ssd_intra(*ptrs, B * nc, Q, H, P, N, _build.stream()),
                 "ssd_intra")
    return y, s
