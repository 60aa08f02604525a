"""Dispatch for the port's kernels.

A CPU tensor goes to the plain PyTorch version in `ref`; a CUDA tensor goes
to the hand-written Hopper kernel, or the call raises. Nothing falls back.
`LAUNCHES` counts kernel launches per kernel (plain-version calls are not
counted), so a run can show that its main path went through the kernels.

The kernels have no backward. A CUDA entry given an input that requires
grad while grad mode is on raises (`_no_backward`), where it would
otherwise return a result cut from the autograd graph; training runs the
plain forms of the models instead (`backbone.forward_train`).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  paged_decode_attention_cuda)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 paged_flash_attention_cuda)
from repro_torch.kernels.rglru_scan import (rglru_gated_scan_cuda,
                                            rglru_scan_cuda)
from repro_torch.kernels.rmsnorm import add_rmsnorm_cuda, rmsnorm_cuda
from repro_torch.kernels.ssd_scan import ssd_intra_cuda

LAUNCHES: Dict[str, int] = {"decode_attention": 0,
                            "paged_decode_attention": 0,
                            "flash_attention": 0,
                            "paged_flash_attention": 0, "rmsnorm": 0,
                            "add_rmsnorm": 0, "ssd_intra": 0,
                            "rglru_scan": 0, "rglru_gated_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _no_backward(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"ops.{name}: the CUDA kernel has no backward, and an input "
            f"requires grad, so its gradient would be cut; train through "
            f"the plain forms (backbone.forward_train), or call the kernel "
            f"under torch.no_grad()")


def decode_attention(q, k, v, q_pos, k_pos, *, window: int = 0):
    """q: (B, H, hd); k/v: (B, S, KV, hd); q_pos: (B,); k_pos: (B, S)."""
    if not q.is_cuda:
        return ref.decode_attention_ref(q, k, v, q_pos, k_pos, window=window)
    _no_backward("decode_attention", q, k, v)
    out = decode_attention_cuda(q, k, v, q_pos, k_pos, window=window)
    LAUNCHES["decode_attention"] += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, q_pos, kpos_pool, tables, *,
                           window: int = 0):
    """Flash decode through the paged KV pools + block tables (DESIGN §9)."""
    if not q.is_cuda:
        return ref.paged_decode_attention_ref(q, k_pool, v_pool, q_pos,
                                              kpos_pool, tables, window=window)
    _no_backward("paged_decode_attention", q, k_pool, v_pool)
    out = paged_decode_attention_cuda(q, k_pool, v_pool, q_pos, kpos_pool,
                                      tables, window=window)
    LAUNCHES["paged_decode_attention"] += 1
    return out


def flash_attention(q, k, v, q_pos, k_pos, *, window: int = 0,
                    causal: bool = True):
    """q: (B, Tq, H, hd); k/v: (B, Tk, KV, hd) -> (B, Tq, H, hd)."""
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, q_pos, k_pos, window=window,
                                       causal=causal)
    _no_backward("flash_attention", q, k, v)
    out = flash_attention_cuda(q, k, v, q_pos, k_pos, window=window,
                               causal=causal)
    LAUNCHES["flash_attention"] += 1
    return out


def paged_flash_attention(q, k_pool, v_pool, q_pos, kpos_pool, tables, *,
                          window: int = 0, causal: bool = True):
    """A chunk's flash attention through the paged KV pools + block tables
    (DESIGN §9): q (B, Tq, H, hd) -> (B, Tq, H, hd)."""
    if not q.is_cuda:
        return ref.paged_flash_attention_ref(q, k_pool, v_pool, q_pos,
                                             kpos_pool, tables, window=window,
                                             causal=causal)
    _no_backward("paged_flash_attention", q, k_pool, v_pool)
    out = paged_flash_attention_cuda(q, k_pool, v_pool, q_pos, kpos_pool,
                                     tables, window=window, causal=causal)
    LAUNCHES["paged_flash_attention"] += 1
    return out


def rmsnorm(x, w, *, eps: float = 1e-6):
    if not x.is_cuda:
        return ref.rmsnorm_ref(x, w, eps=eps)
    _no_backward("rmsnorm", x, w)
    out = rmsnorm_cuda(x, w, eps=eps)
    LAUNCHES["rmsnorm"] += 1
    return out


def add_rmsnorm(x, y, w, *, eps: float = 1e-6):
    """(x + y, rmsnorm(x + y)): the residual add fused into the norm that
    reads it; the sum is x + y in x's dtype, bit for bit."""
    if not x.is_cuda:
        return ref.add_rmsnorm_ref(x, y, w, eps=eps)
    _no_backward("add_rmsnorm", x, y, w)
    out = add_rmsnorm_cuda(x, y, w, eps=eps)
    LAUNCHES["add_rmsnorm"] += 1
    return out


def ssd_intra(xdt, cum_a, Br, Cr):
    """Mamba2 SSD intra-chunk term and chunk states (fp32):
    xdt (B, nc, Q, H, P), cum_a (B, nc, Q, H), Br/Cr (B, nc, Q, N) ->
    y_intra (B, nc, Q, H, P), s_chunk (B, nc, H, P, N)."""
    if not xdt.is_cuda:
        return ref.ssd_intra_ref(xdt, cum_a, Br, Cr)
    _no_backward("ssd_intra", xdt, cum_a, Br, Cr)
    out = ssd_intra_cuda(xdt, cum_a, Br, Cr)
    LAUNCHES["ssd_intra"] += 1
    return out


def rglru_scan(a, bx, h0):
    """h_t = a_t h_{t-1} + bx_t (fp32): a/bx (B, T, W), h0 (B, W) ->
    (h_all (B, T, W), h_T (B, W))."""
    if not a.is_cuda:
        return ref.rglru_scan_ref(a, bx, h0)
    _no_backward("rglru_scan", a, bx, h0)
    out = rglru_scan_cuda(a, bx, h0)
    LAUNCHES["rglru_scan"] += 1
    return out


def rglru_gated_scan(ga, gi, x, lam, b_a, b_i, h0):
    """RecurrentGemma's gated recurrence, the gates and the scan in one
    launch: ga/gi/x (B, T, W) in the working dtype, lam/b_a/b_i (W,) and
    h0 (B, W) fp32 -> (y (B, T, W) in x's dtype, h_T (B, W) fp32)."""
    if not x.is_cuda:
        return ref.rglru_gated_scan_ref(ga, gi, x, lam, b_a, b_i, h0)
    _no_backward("rglru_gated_scan", ga, gi, x, lam, b_a, b_i, h0)
    out = rglru_gated_scan_cuda(ga, gi, x, lam, b_a, b_i, h0)
    LAUNCHES["rglru_gated_scan"] += 1
    return out
