"""Launcher of the hand-written Hopper kernel of the Mamba2 SSD intra-chunk
term (`csrc/ssd_scan.cu`). It replaces the Pallas kernel `ssd_intra_kernel`
of the JAX package; `ref.ssd_intra_ref` is its plain version. CUDA tensors
only: `ops` dispatches CPU tensors to the plain version.

One launch and no scratch: each block forms the C.B^T tile it needs in
registers, and every product runs on the TF32 tensor cores with the 3xTF32
split (fp32-accurate). The wrapper allocates only the two outputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: the kernel's limits: chunk length, head dim, state dim
MAX_Q, MAX_P, MAX_N = 256, 64, 128


def ssd_intra_cuda(xdt, cum_a, Br, Cr):
    """xdt: (B, nc, Q, H, P); cum_a: (B, nc, Q, H); Br/Cr: (B, nc, Q, N),
    all fp32. Returns y_intra (B, nc, Q, H, P), s_chunk (B, nc, H, P, N).
    (The message is formatted only on failure: this runs at every layer of
    a prefill chunk.)"""
    B, nc, Q, H, P = xdt.shape
    N = Br.shape[-1]
    f32 = torch.float32
    if (cum_a.shape != (B, nc, Q, H) or Br.shape != (B, nc, Q, N)
            or Cr.shape != Br.shape or not (Q <= MAX_Q and P <= MAX_P
                                            and N <= MAX_N)
            or xdt.dtype != f32 or cum_a.dtype != f32 or Br.dtype != f32
            or Cr.dtype != f32):
        raise ValueError(
            f"ssd_intra: xdt {tuple(xdt.shape)}, cum_a "
            f"{tuple(cum_a.shape)}, Br {tuple(Br.shape)}, Cr "
            f"{tuple(Cr.shape)}, all fp32, with Q <= {MAX_Q}, P <= {MAX_P} "
            f"and N <= {MAX_N} required")
    y = torch.empty_like(xdt)
    s = torch.empty((B, nc, H, P, N), dtype=f32, device=xdt.device)
    ptrs = _build.cuda_args(xdt, cum_a, Br, Cr, y, s)
    _build.check(_build.library("ssd_scan").ssd_intra(
        *ptrs, B * nc, Q, H, P, N, _build.stream()), "ssd_intra")
    return y, s
