"""The port's kernel plain versions (`repro_torch.kernels.ref`) against the
JAX package's oracles (`repro.kernels.ref`) and its Pallas kernels in
interpret mode, over the shape sweeps of tests/test_kernels.py. (The Hopper
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.)

Inputs come from a numpy seed and go to both packages. Only rows with at
least one visible key are compared with the JAX side: on a row with none,
the JAX oracle returns the mean of V while the port returns 0 by
definition (pinned by its own test below).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from test_torch_cuda import _paged_case, _ssd_inputs

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def both(a, dtype="float32"):
    """One numpy array as (JAX array, torch tensor) of `dtype`."""
    if a.dtype.kind in "iu":
        return jnp.asarray(a), torch.from_numpy(a)
    return (jnp.asarray(a, jnp.float32).astype(JAX_DT[dtype]),
            torch.from_numpy(a.astype(np.float32)).to(TORCH_DT[dtype]))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# decode attention (contiguous)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,S,bs", [
    (2, 8, 2, 32, 64, 32),
    (1, 4, 4, 16, 128, 128),   # MHA-style, single block
    (3, 8, 1, 64, 96, 32),     # MQA, ragged block count
])
def test_decode_attention_plain_matches_jax(B, H, KV, hd, S, bs, dtype):
    rng = np.random.RandomState(7)
    qn = rng.randn(B, H, hd)
    kn, vn = rng.randn(2, B, S, KV, hd)
    q_posn = np.array([S - 1, S // 2, 3][:B], np.int32)
    k_posn = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    k_posn = np.where(k_posn <= q_posn[:, None], k_posn, -1).astype(np.int32)
    (jq, q), (jk, k), (jv, v) = both(qn, dtype), both(kn, dtype), both(vn, dtype)
    (jqp, qp), (jkp, kp) = both(q_posn), both(k_posn)
    got = f32(ops.decode_attention(q, k, v, qp, kp))
    np.testing.assert_allclose(
        got, f32(jref.decode_attention_ref(jq, jk, jv, jqp, jkp)), **tol(dtype))
    if dtype == "float32":
        np.testing.assert_allclose(
            got, f32(jops.decode_attention(jq, jk, jv, jqp, jkp, block_s=bs)),
            **tol(dtype))


def test_decode_attention_ring_buffer_semantics():
    """Positions, not slot order, decide masking — a wrapped ring."""
    rng = np.random.RandomState(1)
    qn, kn, vn = rng.randn(1, 4, 16), rng.randn(1, 8, 1, 16), rng.randn(1, 8, 1, 16)
    k_posn = np.array([[11, 12, 13, 14, 15, 8, 9, 10]], np.int32)
    q_posn = np.array([15], np.int32)
    (jq, q), (jk, k), (jv, v) = both(qn), both(kn), both(vn)
    (jqp, qp), (jkp, kp) = both(q_posn), both(k_posn)
    got = f32(ops.decode_attention(q, k, v, qp, kp, window=4))
    want = f32(jops.decode_attention(jq, jk, jv, jqp, jkp, window=4,
                                     block_s=4))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_rows_without_visible_key_return_zero():
    """A padding row (q_pos = -1) or a row whose keys are all masked
    returns exactly 0 in every attention plain version; the other rows
    still match the JAX oracle."""
    rng = np.random.RandomState(2)
    B, H, KV, hd, S = 3, 4, 2, 16, 32
    q = torch.from_numpy(rng.randn(B, H, hd).astype(np.float32))
    k, v = (torch.from_numpy(a.astype(np.float32))
            for a in rng.randn(2, B, S, KV, hd))
    q_pos = torch.tensor([-1, 20, 5], dtype=torch.int32)
    k_pos = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
    k_pos[2] = -1                                  # row 2: an empty cache
    out = ops.decode_attention(q, k, v, q_pos, k_pos)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    want = jref.decode_attention_ref(*(jnp.asarray(t.numpy()) for t in
                                       (q, k, v, q_pos, k_pos)))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(want)[1],
                               rtol=2e-5, atol=2e-5)
    # the prefill version: a padding query row inside a chunk
    qf = q[:, None].repeat(1, 2, 1, 1)
    qpf = torch.tensor([[-1, -1], [19, 20], [4, 5]], dtype=torch.int32)
    outf = ops.flash_attention(qf, k, v, qpf, k_pos)
    assert torch.equal(outf[0], torch.zeros_like(outf[0]))
    assert torch.equal(outf[2], torch.zeros_like(outf[2]))


# ---------------------------------------------------------------------------
# paged decode attention


@pytest.mark.parametrize("window", [0, 6])
def test_paged_decode_plain_matches_jax(window):
    args = _paged_case(np.random.RandomState(0))
    jargs, targs = zip(*(both(a) for a in args))
    got = f32(ops.paged_decode_attention(*targs, window=window))
    np.testing.assert_allclose(
        got, f32(jref.paged_decode_attention_ref(*jargs, window=window)),
        rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, f32(jops.paged_decode_attention(*jargs, window=window)),
        rtol=2e-5, atol=2e-5)


def test_paged_view_matches_jax():
    q, kp, vp, q_pos, kpos, tables = _paged_case(np.random.RandomState(3))
    (jk, k), (jv, v), (jpp, pp), (jt, t) = \
        both(kp), both(vp), both(kpos), both(tables)
    for got, want in zip(ref.paged_view(k, v, pp, t),
                         jref.paged_view(jk, jv, jpp, jt)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# flash attention (prefill)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Tq,Tk,H,KV,hd,bq,bk,window,causal", [
    (64, 64, 8, 4, 32, 32, 32, 0, True),
    (32, 96, 4, 1, 16, 16, 32, 0, True),    # chunk continuing a cache
    (64, 64, 4, 4, 32, 64, 64, 16, True),   # sliding window
    (32, 32, 8, 2, 16, 32, 32, 0, False),   # bidirectional (encoder)
])
def test_flash_attention_plain_matches_jax(Tq, Tk, H, KV, hd, bq, bk, window,
                                           causal, dtype):
    B = 2
    rng = np.random.RandomState(7)
    (jq, q) = both(rng.randn(B, Tq, H, hd), dtype)
    (jk, k), (jv, v) = (both(a, dtype) for a in rng.randn(2, B, Tk, KV, hd))
    off = Tk - Tq
    qpn = np.broadcast_to(off + np.arange(Tq, dtype=np.int32)[None], (B, Tq))
    kpn = np.broadcast_to(np.arange(Tk, dtype=np.int32)[None], (B, Tk))
    (jqp, qp), (jkp, kp) = both(np.ascontiguousarray(qpn)), \
        both(np.ascontiguousarray(kpn))
    got = f32(ops.flash_attention(q, k, v, qp, kp, window=window,
                                  causal=causal))
    np.testing.assert_allclose(
        got, f32(jref.flash_attention_ref(jq, jk, jv, jqp, jkp, window=window,
                                          causal=causal)), **tol(dtype))
    if dtype == "float32":
        np.testing.assert_allclose(
            got, f32(jops.flash_attention(jq, jk, jv, jqp, jkp, window=window,
                                          causal=causal, block_q=bq,
                                          block_k=bk)), **tol(dtype))


# ---------------------------------------------------------------------------
# fused RMSNorm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,br", [
    ((2, 32, 128), 16),
    ((4, 7, 256), 128),     # rows not a block multiple
    ((1, 1, 64), 8),
])
def test_rmsnorm_plain_matches_jax(shape, br, dtype):
    rng = np.random.RandomState(7)
    (jx, x) = both(rng.randn(*shape), dtype)
    (jw, w) = both(rng.randn(shape[-1]) * 0.1)
    got = f32(ops.rmsnorm(x, w))
    np.testing.assert_allclose(got, f32(jref.rmsnorm_ref(jx, jw)),
                               **tol(dtype))
    if dtype == "float32":
        np.testing.assert_allclose(
            got, f32(jops.rmsnorm(jx, jw, block_rows=br)), **tol(dtype))


# ---------------------------------------------------------------------------
# Mamba2 SSD intra-chunk term


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,nc,Q,H,P,N", [
    (2, 3, 16, 4, 8, 12),
    (1, 1, 64, 2, 32, 16),
    (2, 4, 8, 8, 16, 8),
    (1, 2, 1, 3, 12, 20),     # one-token chunks; P, N not multiples of 8
    (2, 1, 7, 4, 20, 36),     # the ragged last lane chunk of two lanes
])
def test_ssd_intra_plain_matches_jax(B, nc, Q, H, P, N, dtype):
    """The sweep of tests/test_kernels.py; inputs of `dtype` (the Pallas
    kernel and both plain versions compute in fp32)."""
    rng = np.random.RandomState(7)
    (jx, x) = both(rng.randn(B, nc, Q, H, P), dtype)
    (jc, c) = both(-np.abs(rng.randn(B, nc, Q, H)).cumsum(axis=2))
    (jb, b), (jr, r) = (both(a, dtype) for a in rng.randn(2, B, nc, Q, N))
    y, s = ops.ssd_intra(x, c, b, r)
    assert y.dtype == s.dtype == torch.float32
    assert tuple(s.shape) == (B, nc, H, P, N)
    for want in (jref.ssd_intra_ref(jx, jc, jb, jr),
                 jops.ssd_intra(jx, jc, jb, jr)):
        np.testing.assert_allclose(f32(y), f32(want[0]), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(f32(s), f32(want[1]), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["shapes", "Q", "dtype", "cpu"])
def test_ssd_intra_launcher_checks_before_the_card(case):
    """The launcher refuses what the kernel does not take before any
    pointer reaches the card: mismatched shapes, Q over 256, a non-fp32
    operand, and (the last check) a tensor that is not on the card."""
    from repro_torch.kernels.ssd_scan import ssd_intra_cuda

    Q = 257 if case == "Q" else 16
    args = [torch.zeros(s) for s in ((1, 1, Q, 4, 8), (1, 1, Q, 4),
                                      (1, 1, Q, 16), (1, 1, Q, 16))]
    if case == "shapes":
        args[3] = torch.zeros(1, 1, Q, 8)
    if case == "dtype":
        args[1] = args[1].double()
    match = "CUDA tensor" if case == "cpu" else "ssd_intra"
    with pytest.raises(ValueError, match=match):
        ssd_intra_cuda(*args)


def _tf32(x, rna=True):
    """x rounded to TF32 (10 mantissa bits): to nearest with ties away from
    zero, as cvt.rna.tf32.f32, or truncated, as the tensor core reads an
    operand whose 13 low bits are not zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000 if rna else bits) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, split):
    """a @ b as the tensor cores take it: products of TF32 operands, summed
    exactly (float64; the fp32 accumulation adds ~1e-7). One pass rounds
    both operands; the kernel's 3xTF32 split takes big = tf32(x), small =
    x - big (read truncated) and sums a_s b_b + a_b b_s + a_b b_b."""
    if not split:
        return (_tf32(a).double() @ _tf32(b).double()).float()
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a.float() - ab, False), _tf32(b.float() - bb, False)
    return (as_.double() @ bb.double() + ab.double() @ bs.double()
            + ab.double() @ bb.double()).float()


def _ssd_intra_tf32(xdt, cum_a, Br, Cr, split):
    """The SSD term with its three products (C.B^T, W X, (X o d)^T B) taken
    as `_mm_tf32` takes them; W = CB o exp(ca_i - ca_j) on j <= i."""
    Q = xdt.shape[2]
    ca = cum_a.permute(0, 1, 3, 2)                       # (B, nc, H, Q)
    X = xdt.permute(0, 1, 3, 2, 4)                       # (B, nc, H, Q, P)
    cb = _mm_tf32(Cr, Br.transpose(-1, -2), split)       # (B, nc, Q, Q)
    tri = torch.ones(Q, Q, dtype=torch.bool).tril()
    L = torch.where(tri, torch.exp(ca[..., :, None] - ca[..., None, :]),
                    0.0)
    y = _mm_tf32(cb[:, :, None] * L, X, split).permute(0, 1, 3, 2, 4)
    xd = X * torch.exp(ca[..., -1:] - ca)[..., None]
    s = _mm_tf32(xd.transpose(-1, -2), Br[:, :, None], split)
    return y, s


@pytest.mark.parametrize("Q", [16, 256])
def test_ssd_intra_3xtf32_holds_fp32_tolerance(Q):
    """Why the SSD kernel takes its tensor-core products with the 3xTF32
    split and its tolerance stays at 1e-4 x max|plain|: at mamba2-2.7b's
    widths and magnitudes (chip_smoke's inputs), the split lands two orders
    of magnitude inside that tolerance; one TF32 pass misses it."""
    args = [torch.from_numpy(a.astype(np.float32)) for a in
            _ssd_inputs(np.random.RandomState(0), 1, 1, Q, 80, 64, 128)]
    plain = ref.ssd_intra_ref(*args)

    def share(got):
        return [float((g - w).abs().max() / w.abs().max())
                for g, w in zip(got, plain)]

    split, single = share(_ssd_intra_tf32(*args, True)), \
        share(_ssd_intra_tf32(*args, False))
    assert max(split) <= 1e-6, split
    assert min(single) > 1e-4, single


# ---------------------------------------------------------------------------
# RG-LRU linear recurrence


@pytest.mark.parametrize("B,T,W,bw", [
    (2, 32, 256, 128),
    (1, 128, 128, 128),
    (4, 16, 512, 64),
    (3, 9, 100, 0),      # width not a block multiple: the plain version only
])
def test_rglru_scan_plain_matches_jax(B, T, W, bw):
    rng = np.random.RandomState(7)
    (ja, a) = both(1 / (1 + np.exp(-rng.randn(B, T, W))))
    (jb, bx), (jh, h0) = both(rng.randn(B, T, W)), both(rng.randn(B, W))
    y, hT = ops.rglru_scan(a, bx, h0)
    wants = [jref.rglru_scan_ref(ja, jb, jh)]
    if bw:
        wants.append(jops.rglru_scan(ja, jb, jh, block_w=bw))
    for wy, wh in wants:
        np.testing.assert_allclose(f32(y), f32(wy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(f32(hT), f32(wh), rtol=1e-5, atol=1e-5)
