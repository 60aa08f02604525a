"""Plain PyTorch versions of the port's kernels: the CPU path and the
yardstick every Hopper kernel is held against on the card.

The SSD intra-chunk term and the RG-LRU recurrence compute in fp32, as the JAX
package's `kernels/ref.py` does. Attention semantics shared with the
kernels (and, on every row with a visible key, with the JAX package):

* masked scores are -1e30, and a masked key's probability is exactly 0;
* the softmax denominator is clamped at 1e-30, so a row with no visible
  key (a padding row, query position -1) returns 0;
* positions are absolute, -1 marks an empty slot;
* query head h reads kv head h // G (kv-major head layout);
* accumulation is in fp32, the result is cast back to q's dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30
#: RecurrentGemma's c in a_t = exp(-c softplus(Lambda) r_t)
RGLRU_C = 8.0


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with masked entries at exactly 0 and the
    denominator clamped at 1e-30 (all-masked rows give all zeros)."""
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def decode_attention_ref(q, k, v, q_pos, k_pos, *, window: int = 0):
    """q: (B, H, hd); k/v: (B, S, KV, hd); q_pos: (B,); k_pos: (B, S)."""
    B, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qh = q.reshape(B, KV, G, hd).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qh, k.float()) / math.sqrt(hd)
    mask = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window:
        mask = mask & (k_pos > q_pos[:, None] - window)
    p = _masked_softmax(scores, mask[:, None, None, :])
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def paged_view(pool_k, pool_v, pool_pos, tables):
    """Gather a per-request contiguous (B, MB*bs) view of the paged pools
    (DESIGN §9). Logical block j of request b sits at view indices
    [j*bs, (j+1)*bs), so a token at absolute position p lands at view
    index p. Unallocated table entries (-1) read as empty slots
    (K/V = 0, pos = -1)."""
    NB, bs = pool_k.shape[:2]
    B, MB = tables.shape
    offs = torch.arange(bs, device=tables.device)
    idx = (tables.clamp_min(0)[:, :, None] * bs + offs).reshape(B, MB * bs)
    valid = (tables >= 0)[:, :, None].expand(B, MB, bs).reshape(B, MB * bs)
    kf = pool_k.reshape((NB * bs,) + pool_k.shape[2:])
    vf = pool_v.reshape((NB * bs,) + pool_v.shape[2:])
    vm = valid[:, :, None, None]
    k = torch.where(vm, kf[idx], torch.zeros((), dtype=kf.dtype,
                                             device=kf.device))
    v = torch.where(vm, vf[idx], torch.zeros((), dtype=vf.dtype,
                                             device=vf.device))
    kpos = torch.where(valid, pool_pos.reshape(NB * bs)[idx], -1)
    return k, v, kpos


def paged_decode_attention_ref(q, k_pool, v_pool, q_pos, kpos_pool, tables,
                               *, window: int = 0):
    """Gather-then-attend version of the paged decode kernel (DESIGN §9).

    q: (B, H, hd); k/v_pool: (NB, bs, KV, hd); q_pos: (B,);
    kpos_pool: (NB, bs); tables: (B, MB), -1 = unallocated."""
    k, v, kpos = paged_view(k_pool, v_pool, kpos_pool, tables)
    return decode_attention_ref(q, k, v, q_pos, kpos, window=window)


def flash_attention_ref(q, k, v, q_pos, k_pos, *, window: int = 0,
                        causal: bool = True):
    """q: (B, Tq, H, hd); k/v: (B, Tk, KV, hd); q_pos: (B, Tq); k_pos: (B, Tk).

    Returns (B, Tq, H, hd)."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qh = q.reshape(B, Tq, KV, G, hd).float()
    scores = torch.einsum("btkgd,bskd->bkgts", qh, k.float()) / math.sqrt(hd)
    mask = (k_pos[:, None, :] >= 0).expand(B, Tq, k.shape[1])
    if causal:
        mask = mask & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        mask = mask & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    p = _masked_softmax(scores, mask[:, None, None, :, :])
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return out.reshape(B, Tq, H, hd).to(q.dtype)


def paged_flash_attention_ref(q, k_pool, v_pool, q_pos, kpos_pool, tables,
                              *, window: int = 0, causal: bool = True):
    """Gather-then-attend version of the paged chunk kernel (DESIGN §9).

    q: (B, Tq, H, hd); k/v_pool: (NB, bs, KV, hd); q_pos: (B, Tq);
    kpos_pool: (NB, bs); tables: (B, MB), -1 = unallocated."""
    k, v, kpos = paged_view(k_pool, v_pool, kpos_pool, tables)
    return flash_attention_ref(q, k, v, q_pos, kpos, window=window,
                               causal=causal)


def rmsnorm_ref(x, w, *, eps: float = 1e-6):
    """x * rsqrt(mean(x^2) + eps) * (1 + w), in fp32, cast to x.dtype."""
    x32 = x.float()
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(ms + eps) * (1.0 + w.float())
    return y.to(x.dtype)


def add_rmsnorm_ref(x, y, w, *, eps: float = 1e-6):
    """(s, rmsnorm(s)) with s = x + y in x's dtype: the residual add and the
    norm that reads it, the norm taken of the rounded s."""
    s = x + y
    return s, rmsnorm_ref(s, w, eps=eps)


def ssd_intra_ref(xdt, cum_a, Br, Cr):
    """Mamba2 SSD intra-chunk term and per-chunk states, in fp32.

    xdt: (B, nc, Q, H, P) dt-scaled inputs; cum_a: (B, nc, Q, H)
    within-chunk cumulative log-decay; Br/Cr: (B, nc, Q, N).
    Returns y_intra (B, nc, Q, H, P) = ((C B^T) o L) xdt with
    L[i, j] = exp(cum_a_i - cum_a_j) for i >= j, and the chunk states
    s_chunk (B, nc, H, P, N) = ((B o exp(cum_a_end - cum_a))^T xdt)^T."""
    xdt, cum_a = xdt.float(), cum_a.float()
    Br, Cr = Br.float(), Cr.float()
    Q = xdt.shape[2]
    li = cum_a[:, :, :, None, :]
    lj = cum_a[:, :, None, :, :]
    tri = torch.ones(Q, Q, dtype=torch.bool, device=xdt.device).tril()
    L = torch.where(tri[None, None, :, :, None], torch.exp(li - lj), 0.0)
    cb = torch.einsum("bzin,bzjn->bzij", Cr, Br)
    y = torch.einsum("bzijh,bzjhp->bzihp", cb[..., None] * L, xdt)
    decay_to_end = torch.exp(cum_a[:, :, -1:, :] - cum_a)
    s = torch.einsum("bzjn,bzjhp->bzhpn", Br, xdt * decay_to_end[..., None])
    return y, s


def rglru_scan_ref(a, bx, h0):
    """h_t = a_t * h_{t-1} + bx_t, sequentially over t, in fp32.

    a/bx: (B, T, W); h0: (B, W). Returns (h_all (B, T, W), h_T (B, W))."""
    h = h0.float()
    out = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + bx[:, t].float()
        out.append(h)
    return torch.stack(out, dim=1), h


def rglru_gated_scan_ref(ga, gi, x, lam, b_a, b_i, h0):
    """RecurrentGemma's gated recurrence after its two gate products
    (ga = x @ w_a, gi = x @ w_i), op by op in fp32:

        r = sigmoid(ga + b_a), i = sigmoid(gi + b_i)
        a = exp(-c softplus(lam) r)
        h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-9)) (i_t x_t)

    ga/gi/x: (B, T, W); lam/b_a/b_i: (W,) fp32; h0: (B, W) fp32. Returns
    (y (B, T, W) in x's dtype, h_T (B, W) fp32). T = 1 is a decode step."""
    r = torch.sigmoid(ga.float() + b_a)
    i = torch.sigmoid(gi.float() + b_i)
    a = torch.exp(-RGLRU_C * F.softplus(lam.float()) * r)      # (B,T,W)
    # sqrt(1 - a^2) keeps the state's variance
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * x.float())
    h_all, h_last = rglru_scan_ref(a, bx, h0)
    return h_all.to(x.dtype), h_last
