"""The RG-LRU recurrence of the port on the CPU: the model's gated core
(`models/rglru.py: rglru_core`, through `ops.rglru_gated_scan` and its plain
version) against the JAX package's `rglru_core`, and the Hopper kernel's
order of operations (a segmented scan over time: segment pairs, a carry
pass, the segments again from their carries) replayed in torch against the
sequential plain version. The kernel itself is held against the plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.

Inputs come from numpy seeds and go to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rglru import rglru_core as jax_rglru_core
from repro_torch.kernels import ref
from repro_torch.kernels.rglru_scan import (MAX_THREADS, launch_shape,
                                            rglru_gated_scan_cuda,
                                            rglru_scan_cuda)
from repro_torch.models.rglru import rglru_core

#: the H100's SMs, and the steps a thread of the fp32 scan holds
#: (csrc/rglru_scan.cu: max_steps)
SMS, STEPS = 132, 8


def _params(rng, W):
    """RG-LRU gate weights and biases; Lambda as the models initialise it
    (a^c in about (0.9, 0.999))."""
    u = rng.uniform(0.9 ** 2, 0.999 ** 2, W)
    return {"w_a": rng.randn(W, W) * 0.1, "w_i": rng.randn(W, W) * 0.1,
            "b_a": rng.randn(W) * 0.5, "b_i": rng.randn(W) * 0.5,
            "lam": np.log(np.expm1(-np.log(u) / 8.0))}


@pytest.mark.parametrize("B,T,W,mode", [
    (2, 1, 100, "decode"), (3, 1, 64, "decode"),
    (2, 1, 100, "prefill"), (2, 1, 100, "prefill_h0"),
    (2, 7, 100, "prefill"), (2, 7, 100, "prefill_h0"),
    (1, 37, 64, "prefill"), (1, 37, 64, "prefill_h0"),
    (3, 16, 128, "prefill"), (3, 16, 128, "prefill_h0"),
])
def test_rglru_core_matches_jax(B, T, W, mode):
    """fp32, rtol = atol = 1e-5: the port's gated core (one call of
    `ops.rglru_gated_scan`, prefill and decode alike) against the JAX
    package's core (an associative scan in prefill, one step in decode),
    from zeros ("prefill") or a given state."""
    rng = np.random.RandomState(B * 100 + T)
    pn = _params(rng, W)
    xn = rng.randn(B, T, W)
    h0n = rng.randn(B, W) * 2 if mode != "prefill" else None
    p = {k: torch.from_numpy(v.astype(np.float32)) for k, v in pn.items()}
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in pn.items()}
    y, hT = rglru_core(p, torch.from_numpy(xn.astype(np.float32)),
                       h0=None if h0n is None
                       else torch.from_numpy(h0n.astype(np.float32)))
    wy, wh = jax_rglru_core(jp, jnp.asarray(xn, jnp.float32),
                            h0=None if h0n is None
                            else jnp.asarray(h0n, jnp.float32),
                            decode=mode == "decode")
    assert y.dtype == hT.dtype == torch.float32
    assert tuple(y.shape) == (B, T, W) and tuple(hT.shape) == (B, W)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(wh), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the kernel's order of operations


def _fma(a, h, b):
    """fmaf(a, h, b) on fp32 tensors: the product is exact in fp64."""
    return (a.double() * h.double() + b.double()).float()


def _carries(pairs, carry, Q):
    """Each segment's incoming h and the tile's outgoing h, as the kernel's
    carry pass forms them: in segment order, or (Q > 1) in Q groups folded
    into pairs, the groups' carries in order, then each group's."""
    if Q == 1:
        cins = []
        for A, H in pairs:
            cins.append(carry)
            carry = _fma(A, carry, H)
        return cins, carry
    G = -(-len(pairs) // Q)
    groups = [pairs[q * G:(q + 1) * G] for q in range(Q)]
    folded = []
    for grp in groups:
        ga, gh = torch.ones_like(carry), torch.zeros_like(carry)
        for A, H in grp:
            gh = _fma(A, gh, H)
            ga = ga * A
        folded.append((ga, gh))
    group_cins, carry = _carries(folded, carry, 1)
    return [c for grp, gc in zip(groups, group_cins)
            for c in _carries(grp, gc, 1)[0]], carry


def _segmented_scan(a, bx, h0, S, seg_len, Q=1):
    """h_t = a_t h_{t-1} + bx_t as the kernel takes it: tiles of S segments
    of seg_len steps; per segment the pair (A = prod a, H = h_end from 0),
    the carries (`_carries`), then each segment again from its incoming
    carry. With one segment a tile the thread carries its own h."""
    T = a.shape[1]
    y = torch.empty_like(a)
    carry = h0.clone()
    for t0 in range(0, T, S * seg_len):
        segs = [range(min(t0 + s * seg_len, T), min(t0 + (s + 1) * seg_len, T))
                for s in range(S)]
        pairs = []
        for steps in segs:
            A, H = torch.ones_like(h0), torch.zeros_like(h0)
            for t in steps:
                A = A * a[:, t]
                H = _fma(a[:, t], H, bx[:, t])
            pairs.append((A, H))
        cins, carry = _carries(pairs, carry, Q)
        for steps, h in zip(segs, cins):
            for t in steps:
                h = _fma(a[:, t], h, bx[:, t])
                y[:, t] = h
        if S == 1:
            carry = h
    return y, y[:, -1]


def _decay(rng, kind, B, T, W):
    """a and the h0 scale: "mixed" a in [0.5, 1); "strong" a in [0, 0.05]
    with a quarter of the lanes at exactly 0; "near_one" a in [0.99, 1)
    with h0 a hundred times bx."""
    if kind == "strong":
        a = rng.uniform(0, 0.05, (B, T, W))
        a[..., ::4] = 0.0
        return a, 1.0
    if kind == "near_one":
        return rng.uniform(0.99, 1.0, (B, T, W)), 100.0
    return rng.uniform(0.5, 1.0, (B, T, W)), 1.0


@pytest.mark.parametrize("kind", ["mixed", "strong", "near_one"])
@pytest.mark.parametrize("S,seg_len,Q", [(None, None, None), (4, 3, 1),
                                         (16, 1, 1), (16, 8, 1),
                                         (37, 2, 4), (64, 8, 16)])
@pytest.mark.parametrize("T", [1, 7, 16, 37, 512])
def test_segmented_scan_matches_sequential(T, S, seg_len, Q, kind):
    """Within 1e-6 x max|plain| of the sequential plain version: the
    kernel's own segments at B 1, W 4096 (S None: at T 512, 64 segments of
    8 with the carry pass in two levels), ragged ones (len 3), one step a
    segment, tiles (S 16 x len 8 walks T 512 in 4 tiles), and two-level
    carry passes with a ragged last group (37 in 4) and 16 groups of 4."""
    if S is None:
        _, S, seg_len, Q = launch_shape(1, T, 4096, 4, STEPS, SMS)
    rng = np.random.RandomState(T)
    B, W = 2, 64
    an, scale = _decay(rng, kind, B, T, W)
    a, bx, h0 = (torch.from_numpy(v.astype(np.float32)) for v in
                 (an, rng.randn(B, T, W), rng.randn(B, W) * scale))
    y, hT = _segmented_scan(a, bx, h0, S, seg_len, Q)
    wy, wh = ref.rglru_scan_ref(a, bx, h0)
    top = float(wy.abs().max())
    assert float((y - wy).abs().max()) <= 1e-6 * top
    assert float((hT - wh).abs().max()) <= 1e-6 * top
    assert bool(torch.isfinite(y).all())
    if kind == "strong":   # a = 0 lanes: h_t = bx_t exactly
        assert torch.equal(y[..., ::4], bx[..., ::4])


def test_segmented_scan_near_unit_decay_holds_to_fp64():
    """a in [0.9999, 1) over T 512 with a large h0: here the sequential
    fp32 plain version is itself 1-2e-6 x max off the exact recurrence, so
    both orders are held to the fp64 recurrence: the kernel's within 3x the
    sequential's own error (it reads about 2x)."""
    rng = np.random.RandomState(3)
    B, T, W = 1, 512, 256
    an = rng.uniform(0.9999, 1.0, (B, T, W))
    bn, h0n = rng.randn(B, T, W), rng.randn(B, W) * 100
    a, bx, h0 = (torch.from_numpy(v.astype(np.float32))
                 for v in (an, bn, h0n))
    _, S, seg_len, Q = launch_shape(B, T, 4096, 4, STEPS, SMS)
    y, _ = _segmented_scan(a, bx, h0, S, seg_len, Q)
    seq, _ = ref.rglru_scan_ref(a, bx, h0)
    h, exact = h0.double(), torch.empty(B, T, W,
                                                  dtype=torch.float64)
    for t in range(T):   # the recurrence in fp64, from the same fp32 inputs
        h = a[:, t].double() * h + bx[:, t].double()
        exact[:, t] = h
    top = float(exact.abs().max())
    err = float((y.double() - exact).abs().max()) / top
    err_seq = float((seq.double() - exact).abs().max()) / top
    assert err <= 3 * err_seq, (err, err_seq)


def test_launch_shape_fills_the_card():
    """A serving chunk (B 2, T 16) and a long prefill (B 1, T 512) at W
    4096 give every SM a block or two; a decode step (B 8, T 1) too. Every
    shape stays within a block's threads and a thread's registers."""
    lg, S, seg_len, Q = launch_shape(2, 16, 4096, 4, STEPS, SMS)
    assert 2 * (1024 // lg) >= SMS and lg * S * 2 * (1024 // lg) >= 16 * 1024
    # all of T in one tile; the carry pass in 8 groups of 8
    assert launch_shape(1, 512, 4096, 4, STEPS, SMS) == (8, 64, 8, 8)
    lg, S, seg_len, Q = launch_shape(8, 1, 4096, 4, STEPS, SMS)
    assert (S, seg_len, Q) == (1, 1, 1) and 8 * (1024 // lg) >= SMS
    for B in (1, 2, 3, 8):
        for T in (1, 2, 7, 16, 37, 64, 512, 1000):
            for W, vec in ((4096, 4), (1000, 4), (100, 4), (101, 1)):
                for steps in (4, 8):
                    lg, S, seg_len, Q = launch_shape(B, T, W, vec, steps,
                                                     SMS)
                    assert 8 <= lg <= 64 and lg & (lg - 1) == 0
                    assert 1 <= lg * S <= MAX_THREADS
                    assert 1 <= seg_len <= min(steps, T)
                    assert S <= -(-T // seg_len)
                    assert Q == 1 or (Q & (Q - 1) == 0 and vec * Q <= S)


@pytest.mark.parametrize("entry", ["scan", "gated"])
@pytest.mark.parametrize("case", ["shapes", "dtype", "cpu"])
def test_rglru_launchers_check_before_the_card(entry, case):
    """The launchers refuse what the kernel does not take before any
    pointer reaches the card: mismatched shapes, a wrong dtype, and (the
    last check) a tensor that is not on the card."""
    B, T, W = 2, 5, 12
    if entry == "scan":
        args = [torch.zeros(B, T, W), torch.zeros(B, T, W), torch.zeros(B, W)]
        fn, name = rglru_scan_cuda, "rglru_scan"
        bad = 1
    else:
        args = [torch.zeros(B, T, W)] * 3 + [torch.zeros(W)] * 3 \
            + [torch.zeros(B, W)]
        fn, name = rglru_gated_scan_cuda, "rglru_gated_scan"
        bad = 4
    if case == "shapes":
        args[bad] = torch.zeros(W + 1) if entry == "gated" \
            else torch.zeros(B, T + 1, W)
    if case == "dtype":
        args[bad] = args[bad].double()
    with pytest.raises(ValueError, match="CUDA tensor" if case == "cpu"
                       else name):
        fn(*args)
