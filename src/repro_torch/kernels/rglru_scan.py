"""Launchers of the hand-written Hopper kernel of the RG-LRU linear
recurrence (`csrc/rglru_scan.cu`), a segmented scan over time. It replaces
the Pallas kernel `rglru_scan_kernel` of the JAX package. Two entries:

* `rglru_scan_cuda(a, bx, h0)`: the TPU kernel's function,
  h_t = a_t h_{t-1} + bx_t in fp32; `ref.rglru_scan_ref` is its plain
  version.
* `rglru_gated_scan_cuda(ga, gi, x, lam, b_a, b_i, h0)`: RecurrentGemma's
  whole gated recurrence, the gates formed in the kernel's load stage;
  `ref.rglru_gated_scan_ref` is its plain version. The model runs this one,
  in prefill and in decode.

CUDA tensors only: `ops` dispatches CPU tensors to the plain versions.
`launch_shape` picks the block's lane groups and the time segments; the CPU
tests replay the kernel's order of operations with it.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build

#: a block's threads at most, and its lane groups (of 1 or 4 lanes) at
#: most and at least (csrc/rglru_scan.cu: kMaxThreads, kMaxGroups)
MAX_THREADS, MAX_GROUPS, MIN_GROUPS = 512, 64, 8
#: threads a launch aims for per SM before it cuts segments shorter
THREADS_PER_SM = 256
#: segments a tile from which the carry pass runs in two levels
TWO_LEVEL_SEGMENTS = 32


def launch_shape(B: int, T: int, W: int, vec: int, steps: int, sms: int):
    """(LG lane groups a block, S segments a tile, len steps a segment, Q
    carry groups).

    Segments are as long as a thread holds (`steps`) unless that leaves
    fewer than THREADS_PER_SM threads an SM, then halved while it does;
    a block takes the most lane groups that still give every SM a block,
    and as many segments as fit in MAX_THREADS (a longer T is walked in
    tiles of S * len steps). From TWO_LEVEL_SEGMENTS segments on, the
    carry pass runs in Q groups, Q about sqrt(2 S) (its serial steps are
    2 S / Q + Q), with lanes * Q within the block's threads."""
    groups = -(-W // vec)
    seg_len = min(steps, T)
    while seg_len > 1 and B * groups * -(-T // seg_len) < sms * THREADS_PER_SM:
        seg_len //= 2
    segs = -(-T // seg_len)
    lg = MAX_GROUPS
    while lg > MIN_GROUPS and (B * -(-groups // lg) < sms
                               or lg * segs > MAX_THREADS):
        lg //= 2
    segs = min(segs, MAX_THREADS // lg)
    q = 1
    if segs >= TWO_LEVEL_SEGMENTS:
        q = 1 << (min(segs // vec, math.isqrt(2 * segs)).bit_length() - 1)
    return lg, segs, seg_len, q


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def max_steps(gated: bool) -> int:
    """Steps a thread of the entry holds in registers."""
    return _build.library("rglru_scan").rglru_max_steps(int(gated))


def _shape(ptrs, B, T, W, gated, device):
    """(vec, LG, S, len, Q): 4-lane groups where W % 4 == 0 and every
    operand is 16-byte aligned, else 1-lane groups."""
    vec = 4 if W % 4 == 0 and not any(p % 16 for p in ptrs) else 1
    return (vec, *launch_shape(B, T, W, vec, max_steps(gated),
                               _sms(device.index)))


def rglru_scan_cuda(a, bx, h0):
    """a/bx: (B, T, W) fp32; h0: (B, W) fp32. Returns (h_all (B, T, W),
    h_T (B, W)) of h_t = a_t h_{t-1} + bx_t."""
    B, T, W = a.shape
    f32 = torch.float32
    if (bx.shape != a.shape or h0.shape != (B, W) or a.dtype != f32
            or bx.dtype != f32 or h0.dtype != f32):
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} {a.dtype}, bx "
                         f"{tuple(bx.shape)} {bx.dtype}, h0 "
                         f"{tuple(h0.shape)} {h0.dtype}: fp32, a and bx "
                         f"(B, T, W), h0 (B, W)")
    y = torch.empty_like(a)
    hT = torch.empty_like(h0)
    ptrs = _build.cuda_args(a, bx, h0, y, hT)
    shape = _shape(ptrs, B, T, W, False, a.device)
    _build.check(_build.library("rglru_scan").rglru_scan(
        *ptrs, B, T, W, *shape, _build.stream()), "rglru_scan")
    return y, hT


def rglru_gated_scan_cuda(ga, gi, x, lam, b_a, b_i, h0):
    """ga = x @ w_a, gi = x @ w_i, x: (B, T, W) of one dtype (fp32 or
    bf16); lam, b_a, b_i: (W,) fp32; h0: (B, W) fp32. Returns (y (B, T, W)
    in x's dtype, h_T (B, W) fp32). (The message is formatted only on
    failure: this runs at every recurrent layer of every forward.)"""
    B, T, W = x.shape
    f32 = torch.float32
    if (ga.shape != x.shape or gi.shape != x.shape or ga.dtype != x.dtype
            or gi.dtype != x.dtype or x.dtype not in _build.DTYPE_CODE
            or lam.shape != (W,) or b_a.shape != (W,) or b_i.shape != (W,)
            or h0.shape != (B, W) or lam.dtype != f32 or b_a.dtype != f32
            or b_i.dtype != f32 or h0.dtype != f32):
        raise ValueError(
            f"rglru_gated_scan: ga {tuple(ga.shape)} {ga.dtype}, gi "
            f"{tuple(gi.shape)} {gi.dtype}, x {tuple(x.shape)} {x.dtype}, "
            f"lam/b_a/b_i {tuple(lam.shape)}/{tuple(b_a.shape)}/"
            f"{tuple(b_i.shape)}, h0 {tuple(h0.shape)} {h0.dtype}: ga, gi, "
            f"x (B, T, W) of one dtype (fp32 or bf16), the rest fp32")
    code = _build.DTYPE_CODE[x.dtype]
    y = torch.empty_like(x)
    hT = torch.empty((B, W), dtype=f32, device=x.device)
    ptrs = _build.cuda_args(ga, gi, x, lam, b_a, b_i, h0, y, hT)
    shape = _shape(ptrs, B, T, W, True, x.device)
    _build.check(_build.library("rglru_scan").rglru_gated_scan(
        code, *ptrs, B, T, W, *shape, _build.stream()), "rglru_gated_scan")
    return y, hT
