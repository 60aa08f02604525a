"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block in PyTorch, the
port of the JAX package's `models/ssm.py`.

Prefill runs the chunked SSD algorithm: the intra-chunk term and the chunk
states go through `ops.ssd_intra` (the SSD kernel on the card, its plain
version on the CPU); the inter-chunk recurrence is a plain loop over the
chunks. Decode is the O(1) recurrent step. The SSM state is fp32 whatever
the working dtype.

Under tensor-parallel serving (`tp`, a `distributed.sharding.
TensorParallel`) a rank runs its share of the mixer: d_inner/m channels
of z and x in H/m heads (its `in_proj` and `conv_*` cut by segment,
`sharding.segments`), B and C whole, the SSD on its heads, and the gated
norm over all of d_inner by the split form of the RMSNorm kernel (the
rows' sums of squares all-reduced, `ops.rmsnorm_split`); `out_proj`'s
product, over its rows, is then a partial sum made whole by
`layers.down_proj`. The residual stream stays whole.

Training runs the same chunked SSD over the whole sequence in plain
differentiable ops (`ssd_chunked_train`, `mamba2_block_train`): the
intra-chunk term by `ref.ssd_intra_ref` and the gated norm by
`ref.rmsnorm_ref`, never `kernels.ops` (the kernels have no backward).
Under a group it takes the same segment cut: z, x and dt read u through
`TensorParallel.copy`, B and C (every rank's) read u itself and pass
`copy` after the conv, the per-head leaves pass `copy` before the rank
takes its heads, and the gated norm's sum of squares is `TensorParallel.
sum`, so every gradient is the rank's slice of the one-device one.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import ParamInit, down_proj, out_scale


def ssm_dims(cfg: ModelConfig, m: int = 1) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head_dim P, state_dim N); with m, a rank's share
    on a model axis of m: d_inner/m channels in H/m heads."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = s.num_heads or d_inner // s.head_dim
    return d_inner // m, nheads // m, s.head_dim, s.state_dim


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
    dt_bias = init.uniform((n, H), math.log(1e-3), math.log(1e-1),
                           then=lambda u: torch.log(torch.expm1(
                               torch.exp(u))))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": init.zeros(n, conv_ch),
        "dt_bias": dt_bias,
        "A_log": init.made(torch.log(torch.arange(
            1, H + 1, dtype=torch.float32, device=init.device)).repeat(n, 1)),
        "D": init.made(torch.ones(n, H, dtype=torch.float32,
                                  device=init.device)),
        "norm_w": init.zeros(n, d_in),
        "out_proj": init.stacked(n, (d_in, d), out_scale(cfg)),
    }


# ---------------------------------------------------------------------------
# chunked SSD (prefill)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan, the intra-chunk term by `ops.ssd_intra` (the SSD
    kernel on the card).

    x: (B, T, H, P); dt: (B, T, H) post-softplus steps; A: (H,) negative
    decay; Bm/Cm: (B, T, N) (one group); h0: optional (B, H, P, N) state.
    Returns y (B, T, H, P) in x's dtype and the final state (B, H, P, N)
    in fp32. A ragged tail is padded with zero-dt steps, which leave the
    state unchanged (decay 1, no input)."""
    return _ssd_chunked(ops.ssd_intra, x, dt, A, Bm, Cm, chunk, h0)


def ssd_chunked_train(x, dt, A, Bm, Cm, chunk: int):
    """`ssd_chunked` from a zero state in plain differentiable ops (the
    intra-chunk term by `ref.ssd_intra_ref`). Returns (y, final state)."""
    return _ssd_chunked(ref.ssd_intra_ref, x, dt, A, Bm, Cm, chunk, None)


def _ssd_chunked(intra, x, dt, A, Bm, Cm, chunk: int, h0):
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
    y_intra, s_chunk = intra(xdt.contiguous(), cum_a.contiguous(), Br, Cr)

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


def _split_proj(z, cfg: ModelConfig, m: int = 1):
    """in_proj output -> (gate, x, B, C, dt_raw), a rank's on an axis of
    m."""
    d_in, H, _, N = ssm_dims(cfg, m)
    return torch.split(z, [d_in, d_in, N, N, H], dim=-1)


def _heads(v, tp):
    """A replicated per-head leaf (dt_bias, A_log, D): the rank's heads
    (its gradient, a part on each rank, summed by `copy`)."""
    return v if tp is None else tp.copy(v)[tp.part(v.shape[-1])]


def _mixer_in(p, u, cfg: ModelConfig, conv_state, tp=None,
              train: bool = False):
    """in_proj, the causal conv and the SSD's inputs of u (B, T, d):
    (gate, x (B, T, H, P), Bm, Cm, dt (fp32), A, conv_state), of the
    rank's channels and heads under `tp` (`train`: with the gradients of
    the module docstring's cut)."""
    m = 1 if tp is None else tp.m
    d_in, H, P, N = ssm_dims(cfg, m)
    w = p["in_proj"]
    if tp is None or not train:
        z = u @ w
    else:
        uc, c = tp.copy(u), 2 * d_in
        z = torch.cat([uc @ w[:, :c], u @ w[:, c:c + 2 * N],
                       uc @ w[:, c + 2 * N:]], dim=-1)
    gate, xs, Bm, Cm, dt_raw = _split_proj(z, cfg, m)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    xbc, conv_state = causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    if tp is not None:
        Bm, Cm = tp.copy(Bm), tp.copy(Cm)
    Bsz, T, _ = xs.shape
    xh = xs.reshape(Bsz, T, H, P)
    dt = F.softplus(dt_raw.float() + _heads(p["dt_bias"], tp))
    A = -torch.exp(_heads(p["A_log"], tp).float())
    return gate, xh, Bm, Cm, dt, A, conv_state


def _mixer_out(p, y, xh, gate, cfg: ModelConfig, train: bool, tp=None):
    """The skip term D x, the gated RMSNorm (the kernel, or its plain
    version in training; under `tp` the split form over the whole
    d_inner) and out_proj (made whole under `tp`)."""
    D = _heads(p["D"], tp)
    y = y + xh.float().to(y.dtype) * D.to(y.dtype)[None, None, :, None]
    y = y.reshape(y.shape[0], y.shape[1], -1) * F.silu(gate)
    if tp is None:
        norm = ref.rmsnorm_ref if train else ops.rmsnorm
        y = norm(y, p["norm_w"], eps=cfg.rms_eps)
    else:
        split = ref.rmsnorm_split_ref if train else ops.rmsnorm_split
        y = split(y, p["norm_w"], d=ssm_dims(cfg)[0], eps=cfg.rms_eps,
                  reduce=tp.sum if train else tp.reduce)
    return down_proj(y, p["out_proj"], tp)


def mamba2_block(p, u, cfg: ModelConfig, *, conv_state=None, ssm_state=None,
                 decode: bool = False, tp=None):
    """u: (B, T, d). Returns (out (B, T, d), (conv_state, ssm_state)).
    `tp`: the rank's share of the mixer (its params and state slices);
    out is whole on every rank."""
    gate, xh, Bm, Cm, dt, A, conv_state = _mixer_in(p, u, cfg, conv_state,
                                                     tp)
    if decode:
        y, ssm_state = ssd_decode_step(xh, dt, A, Bm, Cm, ssm_state)
    else:
        chunk = min(cfg.ssm.chunk_size, xh.shape[1])
        y, ssm_state = ssd_chunked(xh, dt, A, Bm, Cm, chunk, h0=ssm_state)
    return _mixer_out(p, y, xh, gate, cfg, False, tp), (conv_state,
                                                       ssm_state)


def mamba2_block_train(p, u, cfg: ModelConfig, tp=None):
    """The Mamba2 mixer over the whole sequence u (B, T, d) from zero
    state, in plain differentiable ops; `tp`: the rank's share, as
    `mamba2_block`'s. Returns out (B, T, d)."""
    gate, xh, Bm, Cm, dt, A, _ = _mixer_in(p, u, cfg, None, tp, train=True)
    y, _ = ssd_chunked_train(xh, dt, A, Bm, Cm,
                             min(cfg.ssm.chunk_size, xh.shape[1]))
    return _mixer_out(p, y, xh, gate, cfg, True, tp)
