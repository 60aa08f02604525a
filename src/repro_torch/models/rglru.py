"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427) in PyTorch, the
port of the JAX package's `models/rglru.py`.

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    a_t = exp(-c * softplus(Lambda) * sigmoid(r_t)),  c = 8

The gates and the recurrence run in one call of `ops.rglru_gated_scan` (one
kernel launch on the card, its plain version on the CPU), in prefill and in
decode alike: a decode step is T = 1. Only the two gate products stay
outside it. The recurrent state is fp32 whatever the working dtype.

Training runs the same block over the whole sequence with the plain
recurrence (`ref.rglru_gated_scan_ref`, `rglru_block_train`), never
`kernels.ops` (the kernels have no backward).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import RGLRU_C as _C
from repro_torch.models.layers import ParamInit, out_scale
from repro_torch.models.ssm import causal_conv


def init_rglru_block(init: ParamInit, cfg: ModelConfig, n: int):
    """n stacked RG-LRU blocks with the JAX package's scales. lam, b_a and
    b_i are fp32 whatever the working dtype."""
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    p = {"w_x": init.stacked(n, (d, w)),                  # recurrent branch in
         "w_gate_branch": init.stacked(n, (d, w)),        # gelu branch
         "conv_w": init.stacked(n, (cfg.rglru.conv_width, w), 0.2),
         "conv_b": init.zeros(n, w),
         "w_a": init.stacked(n, (w, w), 0.02),            # recurrence gate
         "b_a": init.zeros(n, w, dtype=torch.float32),
         "w_i": init.stacked(n, (w, w), 0.02),            # input gate
         "b_i": init.zeros(n, w, dtype=torch.float32)}
    # Lambda = softplus^-1(-log(u) / c), u in [0.9^2, 0.999^2]: a^c in
    # about (0.9, 0.999) (the paper's appendix)
    u = init.uniform((n, w), 0.9 ** 2, 0.999 ** 2)
    p["lam"] = torch.log(torch.expm1(-torch.log(u) / _C))
    p["w_out"] = init.stacked(n, (w, d), out_scale(cfg))
    return p


def rglru_core(p, x, *, h0=None):
    """x: (B, T, W) post-conv activations, T = 1 for a decode step; h0:
    (B, W) fp32 state or None (zeros). Returns (y in x's dtype, h_T in
    fp32)."""
    return _core(ops.rglru_gated_scan, p, x, h0)


def _core(scan, p, x, h0):
    """`rglru_core` through `scan`: the kernel's entry (serving) or its
    plain version (training)."""
    if h0 is None:
        h0 = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                         device=x.device)
    return scan(x @ p["w_a"], x @ p["w_i"], x, p["lam"], p["b_a"],
                p["b_i"], h0.contiguous())


def rglru_block(p, u, cfg: ModelConfig, *, conv_state=None, rec_state=None):
    """The RecurrentGemma recurrent block. u: (B, T, d).

    Returns (out (B, T, d), (conv_state, rec_state)). The GeLU of the gate
    branch is the tanh approximation, JAX's default."""
    return _block(ops.rglru_gated_scan, p, u, conv_state, rec_state)


def rglru_block_train(p, u, cfg: ModelConfig):
    """The recurrent block over the whole sequence u (B, T, d) from zero
    state, in plain differentiable ops. Returns out (B, T, d)."""
    out, _ = _block(ref.rglru_gated_scan_ref, p, u, None, None)
    return out


def _block(scan, p, u, conv_state, rec_state):
    """`rglru_block` with the recurrence by `scan` (as `_core`)."""
    gate = F.gelu((u @ p["w_gate_branch"]).float(),
                  approximate="tanh").to(u.dtype)
    x = u @ p["w_x"]
    x, conv_state = causal_conv(x, p["conv_w"], p["conv_b"], conv_state)
    y, rec_state = _core(scan, p, x, rec_state)
    return (y * gate) @ p["w_out"], (conv_state, rec_state)
