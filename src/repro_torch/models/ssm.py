"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block in PyTorch, the
port of the JAX package's `models/ssm.py`.

Prefill runs the chunked SSD algorithm: the intra-chunk term and the chunk
states go through `ops.ssd_intra` (the SSD kernel on the card, its plain
version on the CPU); the inter-chunk recurrence is a plain loop over the
chunks. Decode is the O(1) recurrent step. The SSM state is fp32 whatever
the working dtype.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamInit, out_scale


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head_dim P, state_dim N)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = s.num_heads or d_inner // s.head_dim
    return d_inner, nheads, s.head_dim, s.state_dim


def init_mamba2_block(init: ParamInit, cfg: ModelConfig, n: int):
    """n stacked Mamba2 mixers with the JAX package's scales. A_log,
    dt_bias and D are fp32 whatever the working dtype."""
    d = cfg.d_model
    d_in, H, _, N = ssm_dims(cfg)
    conv_ch = d_in + 2 * N                # x, B and C pass the causal conv
    d_proj = 2 * d_in + 2 * N + H         # z, x, B, C, dt
    in_proj = init.stacked(n, (d, d_proj))
    conv_w = init.stacked(n, (cfg.ssm.conv_width, conv_ch), 0.2)
    # dt_bias = softplus^-1(dt), dt log-uniform in [1e-3, 1e-1]
    dt = torch.exp(init.uniform((n, H), math.log(1e-3), math.log(1e-1)))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": init.zeros(n, conv_ch),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=init.device)).repeat(n, 1),
        "D": torch.ones(n, H, dtype=torch.float32, device=init.device),
        "norm_w": init.zeros(n, d_in),
        "out_proj": init.stacked(n, (d_in, d), out_scale(cfg)),
    }


# ---------------------------------------------------------------------------
# chunked SSD (prefill)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan.

    x: (B, T, H, P); dt: (B, T, H) post-softplus steps; A: (H,) negative
    decay; Bm/Cm: (B, T, N) (one group); h0: optional (B, H, P, N) state.
    Returns y (B, T, H, P) in x's dtype and the final state (B, H, P, N)
    in fp32. A ragged tail is padded with zero-dt steps, which leave the
    state unchanged (decay 1, no input)."""
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-T) % chunk
    if pad:
        def zf(a):
            return torch.cat([a, a.new_zeros(a.shape[:1] + (pad,)
                                             + a.shape[2:])], dim=1)
        x, dt, Bm, Cm = zf(x), zf(dt), zf(Bm), zf(Cm)
    nc = (T + pad) // chunk

    xr = x.reshape(Bsz, nc, chunk, H, P).float()
    dtr = dt.reshape(Bsz, nc, chunk, H).float()
    Br = Bm.reshape(Bsz, nc, chunk, N).float().contiguous()
    Cr = Cm.reshape(Bsz, nc, chunk, N).float().contiguous()

    cum_a = torch.cumsum(dtr * A, dim=2)                  # (B,nc,Q,H)
    xdt = xr * dtr[..., None]                             # (B,nc,Q,H,P)
    y_intra, s_chunk = ops.ssd_intra(xdt.contiguous(), cum_a.contiguous(),
                                     Br, Cr)

    # inter-chunk recurrence: h_c = exp(cum_a_end_c) h_{c-1} + s_c
    chunk_decay = torch.exp(cum_a[:, :, -1, :])           # (B,nc,H)
    h = x.new_zeros((Bsz, H, P, N), dtype=torch.float32) if h0 is None \
        else h0.float()
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = chunk_decay[:, c, :, None, None] * h + s_chunk[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                  # (B,nc,H,P,N)

    # inter-chunk output: C_i . (decay-from-chunk-start * h_prev)
    y_inter = torch.einsum("bzin,bzhpn->bzihp", Cr, h_prev) \
        * torch.exp(cum_a)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, nc * chunk, H, P)[:, :T]
    return y.to(x.dtype), h


def ssd_decode_step(x, dt, A, Bm, Cm, h):
    """One recurrent step. x: (B, 1, H, P); dt: (B, 1, H); Bm/Cm: (B, 1, N);
    h: (B, H, P, N) fp32. Returns (y (B, 1, H, P), h')."""
    xd = x[:, 0].float() * dt[:, 0][..., None]            # (B,H,P)
    a = torch.exp(dt[:, 0].float() * A)                   # (B,H)
    h = a[:, :, None, None] * h + torch.einsum(
        "bn,bhp->bhpn", Bm[:, 0].float(), xd)
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h)
    return y[:, None].to(x.dtype), h


# ---------------------------------------------------------------------------
# causal depthwise conv (prefill and decode)


def causal_conv(x, w, b, state=None):
    """x: (B, T, Ch); w: (W, Ch) depthwise taps; b: (Ch,); state:
    (B, W-1, Ch) history or None. Returns (y, new_state), the sum in fp32
    and y in x's dtype; new_state is the last W-1 inputs."""
    W = w.shape[0]
    Bsz, T, Ch = x.shape
    if state is None:
        state = x.new_zeros((Bsz, W - 1, Ch))
    xin = torch.cat([state.to(x.dtype), x], dim=1)       # (B, W-1+T, Ch)
    y = torch.zeros((Bsz, T, Ch), dtype=torch.float32, device=x.device)
    for i in range(W):
        y = y + xin[:, i:i + T].float() * w[i].float()
    y = (y + b.float()).to(x.dtype)
    return y, xin[:, T:]


# ---------------------------------------------------------------------------
# full block


def _split_proj(z, cfg: ModelConfig):
    """in_proj output -> (gate, x, B, C, dt_raw)."""
    d_in, H, _, N = ssm_dims(cfg)
    return torch.split(z, [d_in, d_in, N, N, H], dim=-1)


def mamba2_block(p, u, cfg: ModelConfig, *, conv_state=None, ssm_state=None,
                 decode: bool = False):
    """u: (B, T, d). Returns (out (B, T, d), (conv_state, ssm_state))."""
    d_in, H, P, N = ssm_dims(cfg)
    z = u @ p["in_proj"]
    gate, xs, Bm, Cm, dt_raw = _split_proj(z, cfg)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    xbc, conv_state = causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    Bsz, T, _ = xs.shape
    xh = xs.reshape(Bsz, T, H, P)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    if decode:
        y, ssm_state = ssd_decode_step(xh, dt, A, Bm, Cm, ssm_state)
    else:
        chunk = min(cfg.ssm.chunk_size, T)
        y, ssm_state = ssd_chunked(xh, dt, A, Bm, Cm, chunk, h0=ssm_state)
    y = y + xh.float().to(y.dtype) * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(Bsz, T, d_in)
    y = ops.rmsnorm(y * F.silu(gate), p["norm_w"], eps=cfg.rms_eps)
    return y @ p["out_proj"], (conv_state, ssm_state)
