"""Meta forms of the port's kernel entries, for the dry run
(`launch.dryrun`): on meta tensors each entry of `ops` comes here. It
allocates what its kernel's wrapper allocates (the outputs, and the
fp32 partials of the key-axis split where the wrapper would make them,
planned for an H100's 132 SMs) and adds the FLOPs of the work to
`FLOPS`, from the shapes alone. It runs no plain version: at T = 32768
`ref.flash_attention_ref` would reckon a (B, H, T, T) score tensor that
the kernel never makes.

The FLOPs count the kernels' products, 2 a multiply-add: attention's
q·kᵀ and p·v over the key slots a query can see (a causal chunk taken as
the last Tq positions of its Tk keys, a window capping each query's
keys; decode sees every slot), the SSD term's C·Bᵀ, its product with
x·dt and the chunk states over whole chunks; and the elementwise
entries their operations an element (RMSNorm 4, the fused add 5, the
scan 2, the gated scan 12).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import split

#: the SMs the key-axis split is planned for (an H100 SXM)
SMS = 132

#: FLOPs of the meta calls since `reset`, by entry
FLOPS: Dict[str, int] = {}


def reset() -> None:
    FLOPS.clear()


def _count(name: str, n: int) -> None:
    FLOPS[name] = FLOPS.get(name, 0) + int(n)


def _split_partials(q, B, KV, rows, Tk, hd, out_rows, partial=False):
    """The fp32 (m, l, O) partials `split.plan` allocates for a bf16 call
    whose grid would be under half a wave, or any bf16 `partial` call
    (none otherwise)."""
    if q.dtype != torch.bfloat16:
        return []
    ns = split.num_splits(B, KV, split.row_tiles(rows),
                          -(-Tk // split.key_tile(hd, rows)), SMS)
    if ns == 1 and not partial:
        return []
    return [q.new_empty((ns, out_rows, hd), dtype=torch.float32),
            q.new_empty((ns, out_rows, 2), dtype=torch.float32)]


def visible_pairs(Tq: int, Tk: int, window: int, causal: bool) -> int:
    """(query, key) pairs a chunk of Tq queries sees among Tk keys: query
    i, the last Tq positions' i-th, sees keys up to its own (Tk - Tq + i +
    1 of them), at most `window`; every key when not causal."""
    if not causal:
        return Tq * (min(Tk, window) if window else Tk)
    a = Tk - Tq + 1                          # the first query's keys
    if not window or a + Tq - 1 <= window:
        return Tq * a + Tq * (Tq - 1) // 2
    if a >= window:
        return Tq * window
    j = window - a                           # queries below the cap
    return j * a + j * (j - 1) // 2 + (Tq - j) * window


def _attention(name, q, Tk, KV, window, causal, Tq):
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    out = torch.empty_like(q)
    partials = _split_partials(q, B, KV, Tq * (H // KV), Tk, hd,
                               B * Tq * H)
    _count(name, 4 * B * H * hd * visible_pairs(Tq, Tk, window, causal))
    del partials
    return out


def decode_attention(q, k, v, q_pos, k_pos, *, window: int = 0):
    return _attention("decode_attention", q, k.shape[1], k.shape[2],
                      window, False, 1)


def paged_decode_attention(q, k_pool, v_pool, q_pos, kpos_pool, tables, *,
                           window: int = 0):
    return _attention("paged_decode_attention", q,
                      tables.shape[1] * k_pool.shape[1], k_pool.shape[2],
                      window, False, 1)


def flash_attention(q, k, v, q_pos, k_pos, *, window: int = 0,
                    causal: bool = True):
    return _attention("flash_attention", q, k.shape[1], k.shape[2], window,
                      causal, q.shape[1])


def paged_flash_attention(q, k_pool, v_pool, q_pos, kpos_pool, tables, *,
                          window: int = 0, causal: bool = True):
    return _attention("paged_flash_attention", q,
                      tables.shape[1] * k_pool.shape[1], k_pool.shape[2],
                      window, causal, q.shape[1])


def decode_attention_partial(q, k, v, q_pos, k_pos, *, window: int = 0):
    """The fp32 (o, ml) of the rank's slots, and the splits' partials its
    bf16 launch makes (`decode_attention_partial_cuda`)."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    partials = _split_partials(q, B, KV, H // KV, S, hd, B * H, partial=True)
    _count("decode_attention_partial",
           4 * B * H * hd * visible_pairs(1, S, window, False))
    del partials
    return (q.new_empty((B, H, hd), dtype=torch.float32),
            q.new_empty((B, H, 2), dtype=torch.float32))


def attention_combine(o, ml, *, dtype=torch.float32):
    """(B, H, hd) in `dtype`; 2 FLOPs a part's weighted element and
    l."""
    R, B, H, hd = o.shape
    _count("attention_combine", 2 * R * B * H * (hd + 1))
    return o.new_empty((B, H, hd), dtype=dtype)


def rmsnorm(x, w, *, eps: float = 1e-6):
    _count("rmsnorm", 4 * x.numel())
    return torch.empty_like(x)


def add_rmsnorm(x, y, w, *, eps: float = 1e-6):
    _count("add_rmsnorm", 5 * x.numel())
    return torch.empty_like(x), torch.empty_like(x)


def rmsnorm_split(x, w, *, d: int, eps: float = 1e-6, reduce=None):
    """The split norm's two launches around the group's all-reduce of the
    rows' sums (`reduce` runs, so a recording group sees it)."""
    ss = x.new_empty(x.shape[:-1], dtype=torch.float32)
    if reduce is not None:
        ss = reduce(ss)
    _count("rmsnorm_split", 4 * x.numel())
    return torch.empty_like(x)


def ssd_intra(xdt, cum_a, Br, Cr):
    B, nc, Q, H, P = xdt.shape
    N = Br.shape[-1]
    _count("ssd_intra", 2 * B * nc * (Q * Q * N + Q * Q * H * P
                                      + Q * H * P * N))
    return (torch.empty_like(xdt),
            xdt.new_empty((B, nc, H, P, N), dtype=torch.float32))


def rglru_scan(a, bx, h0):
    _count("rglru_scan", 2 * a.numel())
    return torch.empty_like(a), torch.empty_like(h0)


def rglru_gated_scan(ga, gi, x, lam, b_a, b_i, h0):
    _count("rglru_gated_scan", 12 * x.numel())
    return (torch.empty_like(x),
            x.new_empty((x.shape[0], x.shape[2]), dtype=torch.float32))
