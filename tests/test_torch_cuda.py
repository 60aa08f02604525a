"""The port's Hopper kernels against their plain PyTorch versions, on an
NVIDIA GPU at the serving path's widths. Marked `cuda`: they skip on a
machine without a card. This file imports no JAX, so it runs where the
card is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


def _paged_case(rng):
    B, H, KV, hd, NB, bs, MB = 3, 4, 2, 16, 10, 8, 4
    q = rng.randn(B, H, hd)
    kp, vp = rng.randn(2, NB, bs, KV, hd)
    owned = [[2, 5, 7], [1], [9, 0]]       # non-contiguous, non-monotone
    tables = np.full((B, MB), -1, np.int32)
    for b, tbl in enumerate(owned):
        tables[b, :len(tbl)] = tbl
    q_pos = np.array([20, 5, 11], np.int32)
    kpos = np.full((NB, bs), -1, np.int32)
    for b, tbl in enumerate(owned):
        for j, pb in enumerate(tbl):
            for o in range(bs):
                if j * bs + o <= q_pos[b]:
                    kpos[pb, o] = j * bs + o
    kpos[3] = 2   # stale positions in an UNOWNED block must stay invisible
    return q, kp, vp, q_pos, kpos, tables


def _paged_pools(rng, lens, bs, MB, KV, hd, holes=()):
    """Paged pools holding len(lens) rows: row b's tokens sit at positions
    [0, lens[b]) in shuffled physical blocks of bs slots; its table entries
    are -1 past its last block and at the (row, block) pairs in `holes`
    (whose positions then read as empty); one block that no table names
    holds stale positions, which must stay invisible. Returns k/v pools
    (NB, bs, KV, hd), kpos (NB, bs), tables (B, MB)."""
    B = len(lens)
    NB = sum(-(-n // bs) for n in lens) + 3
    perm = rng.permutation(NB)
    tables = np.full((B, MB), -1, np.int32)
    kpos = np.full((NB, bs), -1, np.int32)
    used = 0
    for b, n in enumerate(lens):
        for j in range(-(-n // bs)):
            if (b, j) in holes:
                continue
            tables[b, j] = perm[used]
            pos = j * bs + np.arange(bs)
            kpos[perm[used]] = np.where(pos < n, pos, -1)
            used += 1
    kpos[perm[used]] = np.arange(bs)
    kp, vp = rng.randn(2, NB, bs, KV, hd)
    return kp, vp, kpos, tables


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernels run only there")
    ops.reset_launches()
    return torch.device("cuda")


def _on(dev, *arrays, dtype=torch.bfloat16):
    return [torch.from_numpy(a).to(dev) if a.dtype.kind in "iu"
            else torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
            for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(1, 1024), (8, 1000)])
def test_decode_kernel_matches_plain_on_card(cuda, B, S):
    rng = np.random.RandomState(0)
    H, KV, hd = 32, 8, 128
    q_pos = rng.randint(-1, S, size=B).astype(np.int32)
    k_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    q, k, v, qp, kp = _on(cuda, rng.randn(B, H, hd), rng.randn(B, S, KV, hd),
                          rng.randn(B, S, KV, hd), q_pos, k_pos)
    got = ops.decode_attention(q, k, v, qp, kp)
    want = ref.decode_attention_ref(q, k, v, qp, kp)
    assert ops.LAUNCHES["decode_attention"] == 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_paged_decode_kernel_matches_plain_on_card(cuda):
    q, kp, vp, q_pos, kpos, tables = _paged_case(np.random.RandomState(0))
    args = _on(cuda, q, kp, vp, q_pos, kpos, tables, dtype=torch.float32)
    got = ops.paged_decode_attention(*args)
    want = ref.paged_decode_attention_ref(*args)
    assert ops.LAUNCHES["paged_decode_attention"] == 1
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("Tq", [16, 500])
def test_flash_kernel_matches_plain_on_card(cuda, Tq):
    rng = np.random.RandomState(0)
    B, Tk, H, KV, hd = 1, 1024, 32, 8, 128
    qp = np.arange(Tk - Tq, Tk, dtype=np.int32)[None]
    kp = np.arange(Tk, dtype=np.int32)[None]
    q, k, v, qpt, kpt = _on(cuda, rng.randn(B, Tq, H, hd),
                            rng.randn(B, Tk, KV, hd),
                            rng.randn(B, Tk, KV, hd), qp, kp)
    got = ops.flash_attention(q, k, v, qpt, kpt)
    want = ref.flash_attention_ref(q, k, v, qpt, kpt)
    assert ops.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 4096])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, rows):
    rng = np.random.RandomState(0)
    x, w = _on(cuda, rng.randn(rows, 4096), rng.randn(4096) * 0.1)
    got = ops.rmsnorm(x, w)
    assert ops.LAUNCHES["rmsnorm"] == 1
    torch.testing.assert_close(got.float(), ref.rmsnorm_ref(x, w).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,m", [(8, 5120, 2), (16, 5120, 2),
                                      (8, 4096, 1), (5, 1000, 4)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_rmsnorm_split_kernel_matches_plain_on_card(cuda, rows, d, m, dtype):
    """The split form of the RMSNorm kernel on m ranks' slices of rows of
    width d (each slice's sums made whole by adding the other slices'
    fp32 sums, as the group's all-reduce does) against its plain version
    on the same slices, and the slices put together against the rmsnorm
    kernel over the whole rows; over a whole row (m = 1, no reduce) it is
    the rmsnorm kernel bit for bit. One launch count a call."""
    rng = np.random.RandomState(1)
    x, w = _on(cuda, rng.randn(rows, d) * 2, rng.randn(d) * 0.1,
               dtype=getattr(torch, dtype))
    k = d // m
    parts = [x[:, r * k:(r + 1) * k].contiguous() for r in range(m)]
    sums = [(p.float() ** 2).sum(-1) for p in parts]
    total = sum(sums[1:], sums[0])
    got, want = [], []
    for r, p in enumerate(parts):
        wr = w[r * k:(r + 1) * k].clone()      # 16-byte aligned, as a shard
        reduce = (lambda s, r=r: s - sums[r] + total) if m > 1 else None
        got.append(ops.rmsnorm_split(p, wr, d=d, reduce=reduce))
        want.append(ref.rmsnorm_split_ref(p, wr, d=d, reduce=reduce))
    assert ops.LAUNCHES["rmsnorm_split"] == m
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)
    for g, wa in zip(got, want):
        torch.testing.assert_close(g.float(), wa.float(), **tol)
    whole = ops.rmsnorm(x, w)
    if m == 1:
        assert torch.equal(got[0], whole)
    torch.testing.assert_close(torch.cat(got, -1).float(), whole.float(),
                               **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_model_on_card_matches_cpu(cuda, paged):
    """Reduced granite in fp32: chunked prefill + decode through the
    kernels on the card gives the CPU plain path's logits."""
    from repro_torch.config.registry import get_config
    from repro_torch.models.model import build_model

    cfg = get_config("granite-3-8b", "reduced")
    m_gpu = build_model(cfg, torch.float32, cuda)
    m_cpu = build_model(cfg, torch.float32, "cpu")
    p_cpu = m_cpu.init(0)

    def to(p, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in p.items()}

    toks = torch.randint(0, cfg.vocab_size, (2, 30),
                         generator=torch.Generator().manual_seed(0))
    pos = torch.arange(30, dtype=torch.int32)[None].repeat(2, 1)
    outs = []
    for m, p, dev in ((m_gpu, to(p_cpu, cuda), cuda), (m_cpu, p_cpu, "cpu")):
        if paged:
            cache = m.init_paged_cache(8, 16)
            tables = torch.tensor([[0, 1, -1, -1], [5, 3, -1, -1]],
                                  dtype=torch.int32, device=dev)
            step = lambda t, q, c: m.prefill_paged(p, t, q, tables, c)  # noqa: E731
        else:
            cache = m.init_cache(2, 64)
            step = lambda t, q, c: m.prefill(p, t, q, c)  # noqa: E731
        seq = []
        for s, e in ((0, 24), (24, 25), (25, 26), (26, 30)):
            lg, cache = step(toks[:, s:e].to(dev), pos[:, s:e].to(dev), cache)
            seq.append(lg.cpu())
        outs.append(torch.cat(seq, 1))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)
    used = ("paged_decode_attention" if paged else "decode_attention",
            "paged_flash_attention" if paged else "flash_attention",
            "rmsnorm", "add_rmsnorm")
    assert all(ops.LAUNCHES[k] > 0 for k in used), ops.LAUNCHES


def _close_normwise(got, want, tol=1e-4):
    """fp32 kernels: every element within tol * max|want| (sums of up to
    Q * N products taken in another order than the plain version's)."""
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


def _ssd_inputs(rng, B, nc, Q, H, P, N, dt=None, a_max=None):
    """mamba2-like magnitudes: dt in [1e-3, 1e-1] (or fixed at `dt`), A
    from -1 down to -H (or -a_max)."""
    dt = rng.uniform(1e-3, 1e-1, (B, nc, Q, H)) if dt is None \
        else np.full((B, nc, Q, H), dt)
    A = -np.linspace(1, a_max or H, H)
    xdt = rng.randn(B, nc, Q, H, P) * dt[..., None]
    cum_a = np.cumsum(dt * A, axis=2)
    Br, Cr = rng.randn(2, B, nc, Q, N)
    return xdt, cum_a, Br, Cr


@pytest.mark.cuda
@pytest.mark.parametrize("B,nc,Q,H,P,N", [
    (1, 1, 16, 80, 64, 128),     # the serving chunk of mamba2-2.7b
    (1, 2, 256, 80, 64, 128),    # the config's chunk
    (2, 3, 40, 4, 32, 16),       # ragged tiles, reduced widths
    (1, 1, 1, 80, 64, 128),      # a one-token chunk
    (2, 1, 7, 80, 64, 128),      # the ragged last lane chunk, two lanes
    (2, 1, 16, 80, 64, 128),     # two full lane chunks
    (1, 1, 100, 80, 64, 128),    # a ragged prompt in one chunk
    (2, 2, 37, 3, 24, 40),       # odd widths: the 4-byte staging path
])
def test_ssd_intra_kernel_matches_plain_on_card(cuda, B, nc, Q, H, P, N):
    args = _on(cuda, *_ssd_inputs(np.random.RandomState(0), B, nc, Q, H, P,
                                  N), dtype=torch.float32)
    y, s = ops.ssd_intra(*args)
    yr, sr = ref.ssd_intra_ref(*args)
    assert ops.LAUNCHES["ssd_intra"] == 1
    _close_normwise(y, yr)
    _close_normwise(s, sr)


@pytest.mark.cuda
def test_ssd_intra_kernel_strong_decay_on_card(cuda):
    """dt 0.1 and A down to -80 at Q 256: cum_a reaches -2048, so most
    decays underflow to 0; masked and padded entries must stay 0, never
    inf * 0."""
    args = _on(cuda, *_ssd_inputs(np.random.RandomState(1), 1, 2, 256, 80,
                                  64, 128, dt=0.1, a_max=80),
               dtype=torch.float32)
    y, s = ops.ssd_intra(*args)
    yr, sr = ref.ssd_intra_ref(*args)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    _close_normwise(y, yr)
    _close_normwise(s, sr)


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [7, 256])
def test_ssd_intra_is_one_device_kernel(cuda, Q):
    """One call runs exactly one device kernel (no C.B^T pass, no scratch
    fill), counted by torch.profiler."""
    from repro_torch.bench.ssd_sweep import device_kernels

    args = _on(cuda, *_ssd_inputs(np.random.RandomState(0), 1, 2, Q, 80, 64,
                                  128), dtype=torch.float32)
    names = device_kernels(lambda: ops.ssd_intra(*args), calls=10)
    # ten calls, one kernel each (the profiler may miss a record or two)
    assert 8 <= len(names) <= 10 and all("ssd_kernel" in n for n in names), \
        names


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,W", [
    (2, 16, 4096), (1, 512, 4096), (3, 37, 1000),   # the serving widths
    (3, 1, 4096), (2, 7, 1000), (1, 64, 100),       # short T, ragged tiles
    (1, 1000, 4096), (2, 1000, 100),                # T walked in tiles
    (3, 16, 101), (1, 37, 6),                       # W % 4 != 0: 1-lane path
])
def test_rglru_scan_kernel_matches_plain_on_card(cuda, B, T, W):
    rng = np.random.RandomState(0)
    a, bx, h0 = _on(cuda, rng.uniform(0.5, 1.0, (B, T, W)),
                    rng.randn(B, T, W), rng.randn(B, W), dtype=torch.float32)
    y, hT = ops.rglru_scan(a, bx, h0)
    yr, hTr = ref.rglru_scan_ref(a, bx, h0)
    assert ops.LAUNCHES["rglru_scan"] == 1
    _close_normwise(y, yr)
    _close_normwise(hT, hTr)
    assert torch.equal(hT, y[:, -1])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 512])
@pytest.mark.parametrize("kind", ["strong", "near_one"])
def test_rglru_scan_kernel_decay_extremes_on_card(cuda, kind, T):
    """a in [0, 0.05] with a quarter of the lanes at exactly 0 (h_t = bx_t
    there, no 0 x inf), and a in [0.99, 1) from an h0 a hundred times bx."""
    rng = np.random.RandomState(1)
    B, W = 2, 4096
    if kind == "strong":
        an = rng.uniform(0, 0.05, (B, T, W))
        an[..., ::4] = 0.0
    else:
        an = rng.uniform(0.99, 1.0, (B, T, W))
    a, bx, h0 = _on(cuda, an, rng.randn(B, T, W),
                    rng.randn(B, W) * (100 if kind == "near_one" else 1),
                    dtype=torch.float32)
    y, hT = ops.rglru_scan(a, bx, h0)
    yr, hTr = ref.rglru_scan_ref(a, bx, h0)
    assert bool(torch.isfinite(y).all())
    _close_normwise(y, yr)
    _close_normwise(hT, hTr)
    if kind == "strong":
        assert torch.equal(y[..., ::4], bx[..., ::4])


def _gated_inputs(rng, B, T, W):
    """Gate pre-activations and x of unit scale, Lambda as the model
    initialises it, small biases, a unit-scale h0."""
    u = rng.uniform(0.9 ** 2, 0.999 ** 2, W)
    return (rng.randn(B, T, W), rng.randn(B, T, W), rng.randn(B, T, W),
            np.log(np.expm1(-np.log(u) / 8.0)), rng.randn(W) * 0.1,
            rng.randn(W) * 0.1, rng.randn(B, W))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,W", [
    (2, 16, 4096), (8, 1, 4096), (1, 512, 4096),    # chunk, decode, prefill
    (3, 37, 1000), (2, 7, 100), (2, 5, 101),        # ragged; 1-lane path
])
def test_rglru_gated_scan_matches_plain_on_card(cuda, B, T, W, dtype):
    """fp32 against the plain version within 1e-4 x max|plain|; bf16
    against the fp32 plain version at atol = rtol = 2e-2 (h_T, fp32
    either way, within 1e-4 x max|plain|)."""
    args = _on(cuda, *_gated_inputs(np.random.RandomState(0), B, T, W),
               dtype=torch.float32)
    if dtype == "bfloat16":
        args[:3] = [t.bfloat16() for t in args[:3]]
    y, hT = ops.rglru_gated_scan(*args)
    yr, hTr = ref.rglru_gated_scan_ref(*[t.float() for t in args])
    assert ops.LAUNCHES["rglru_gated_scan"] == 1
    assert y.dtype == args[2].dtype and hT.dtype == torch.float32
    if dtype == "float32":
        _close_normwise(y, yr)
    else:
        torch.testing.assert_close(y.float(), yr, rtol=2e-2, atol=2e-2)
    _close_normwise(hT, hTr)


@pytest.mark.cuda
@pytest.mark.parametrize("entry,T", [("scan", 16), ("scan", 512),
                                     ("gated", 1), ("gated", 16),
                                     ("gated", 512)])
def test_rglru_entries_are_one_device_kernel(cuda, entry, T):
    """One call runs exactly one device kernel, counted by torch.profiler
    (the gated entry: no gate op, no temporary, no cast launched)."""
    from repro_torch.bench.ssd_sweep import device_kernels

    rng = np.random.RandomState(0)
    B, W = 2, 4096
    if entry == "scan":
        args = _on(cuda, rng.uniform(0.5, 1.0, (B, T, W)),
                   rng.randn(B, T, W), rng.randn(B, W), dtype=torch.float32)
        fn = lambda: ops.rglru_scan(*args)  # noqa: E731
    else:
        args = _on(cuda, *_gated_inputs(rng, B, T, W), dtype=torch.float32)
        args[:3] = [t.bfloat16() for t in args[:3]]
        fn = lambda: ops.rglru_gated_scan(*args)  # noqa: E731
    names = device_kernels(fn, calls=10)
    if not names:
        # the profiler now and then records no kernel at all: profile again
        names = device_kernels(fn, calls=10)
    # ten calls, one kernel each (the profiler may miss a record or two)
    assert 8 <= len(names) <= 10 and all("rglru_kernel" in n
                                         for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("S,window", [(1024, 0), (2048, 2048), (2048, 512)])
def test_decode_kernel_head_dim_256_on_card(cuda, S, window):
    """recurrentgemma-9b's local attention: 16 heads on 1 kv head of 256."""
    rng = np.random.RandomState(0)
    B, H, KV, hd = 8, 16, 1, 256
    q_pos = rng.randint(S // 2, S + window, size=B).astype(np.int32)
    k_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    # a ring: slot s holds the newest position congruent to s mod S
    k_pos = np.where(k_pos + S <= q_pos[:, None], k_pos + S, k_pos)
    q, k, v, qp, kp = _on(cuda, rng.randn(B, H, hd), rng.randn(B, S, KV, hd),
                          rng.randn(B, S, KV, hd), q_pos, k_pos)
    got = ops.decode_attention(q, k, v, qp, kp, window=window)
    want = ref.decode_attention_ref(q.float(), k.float(), v.float(), qp, kp,
                                    window=window)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_paged_decode_kernel_head_dim_256_on_card(cuda):
    rng = np.random.RandomState(0)
    B, H, KV, hd, NB, bs, MB = 4, 16, 1, 256, 40, 16, 8
    tables = rng.permutation(NB)[:B * MB].reshape(B, MB).astype(np.int32)
    tables[1, 5:] = -1
    q_pos = np.array([127, 70, 100, 3], np.int32)
    kpos = np.full((NB, bs), -1, np.int32)
    for b in range(B):
        for j, pb in enumerate(tables[b]):
            if pb >= 0:
                kpos[pb] = np.where(j * bs + np.arange(bs) <= q_pos[b],
                                    j * bs + np.arange(bs), -1)
    args = _on(cuda, rng.randn(B, H, hd), rng.randn(NB, bs, KV, hd),
               rng.randn(NB, bs, KV, hd), q_pos, kpos, tables)
    got = ops.paged_decode_attention(*args, window=64)
    want = ref.paged_decode_attention_ref(args[0].float(), args[1].float(),
                                          args[2].float(), *args[3:],
                                          window=64)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("Tq", [16, 500])
def test_flash_kernel_head_dim_256_on_card(cuda, Tq):
    rng = np.random.RandomState(0)
    B, Tk, H, KV, hd = 1, 1024, 16, 1, 256
    qp = np.arange(Tk - Tq, Tk, dtype=np.int32)[None]
    kp = np.arange(Tk, dtype=np.int32)[None]
    q, k, v, qpt, kpt = _on(cuda, rng.randn(B, Tq, H, hd),
                            rng.randn(B, Tk, KV, hd),
                            rng.randn(B, Tk, KV, hd), qp, kp)
    got = ops.flash_attention(q, k, v, qpt, kpt, window=512)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), qpt, kpt,
                                   window=512)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# the bf16 tensor-core kernels (packed GQA rows, key-axis split and combine,
# tile skip) against the fp32 plain versions at atol = rtol = 2e-2


def _decode_bf16(dev, rng, S, H, KV, hd, q_pos, k_pos, window=0):
    B = len(q_pos)
    args = _on(dev, rng.randn(B, H, hd), rng.randn(B, S, KV, hd),
               rng.randn(B, S, KV, hd), np.asarray(q_pos, np.int32),
               np.asarray(k_pos, np.int32))
    got = ops.decode_attention(*args, window=window)
    want = ref.decode_attention_ref(*[a.float() for a in args[:3]], *args[3:],
                                    window=window)
    assert ops.LAUNCHES["decode_attention"] == 1
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4, 16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_decode_bf16_group_sizes_on_card(cuda, G, hd):
    """G query heads packed as rows (padded to 16 at G < 16), rows filled
    to 700 / 351 / 41 of 700 slots (a ragged last tile, empty tails)."""
    S, KV = 700, 2
    q_pos = np.array([699, 350, 40])
    ar = np.arange(S)[None]
    _decode_bf16(cuda, np.random.RandomState(1), S, G * KV, KV, hd, q_pos,
                 np.where(ar <= q_pos[:, None], ar, -1))


@pytest.mark.cuda
def test_decode_bf16_long_row_splits_on_card(cuda):
    """B = 1: the (B, KV) grid is 8 blocks, so the key axis is split and
    the combine pass runs."""
    from repro_torch.kernels import split

    S, H, KV, hd = 4096, 32, 8, 128
    assert split.num_splits(1, KV, split.row_tiles(H // KV),
                            S // split.key_tile(hd, H // KV),
                            split.sm_count(cuda.index or 0)) > 1
    _decode_bf16(cuda, np.random.RandomState(2), S, H, KV, hd, [S - 1],
                 np.arange(S)[None])


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 300])
def test_decode_bf16_split_edges_on_card(cuda, window):
    """Rows whose visible keys fall in only some splits: 70 keys (the first
    split only), a padding row (q_pos -1: exactly 0), a row filled to 1500
    with an empty tail, and a ring that wrapped (slots 0-499 hold positions
    S..S+499)."""
    S, H, KV, hd = 2048, 8, 2, 128
    ar = np.arange(S)
    q_pos = [69, -1, 1499, S + 499]
    k_pos = np.stack([np.where(ar < 70, ar, -1), ar,
                      np.where(ar < 1500, ar, -1),
                      np.where(ar < 500, ar + S, ar)])
    got = _decode_bf16(cuda, np.random.RandomState(3), S, H, KV, hd, q_pos,
                       k_pos, window=window)
    assert bool((got[1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 256])
@pytest.mark.parametrize("Tq", [2, 16, 17, 63, 500])
def test_flash_bf16_chunk_lengths_on_card(cuda, Tq, window):
    """Chunks of Tq tokens (G 4 heads each, token-major rows) against a
    1024-slot row: one chunk ends at 600 in a row filled to it, one starts
    the row (the rest empty) and ends on a padding query (q_pos -1:
    exactly 0)."""
    rng = np.random.RandomState(4)
    B, Tk, H, KV, hd = 2, 1024, 8, 2, 128
    ends = [600, Tq]
    qp = np.stack([np.arange(e - Tq, e) for e in ends]).astype(np.int32)
    qp[1, -1] = -1
    kp = np.stack([np.where(np.arange(Tk) < e, np.arange(Tk), -1)
                   for e in ends]).astype(np.int32)
    q, k, v, qpt, kpt = _on(cuda, rng.randn(B, Tq, H, hd),
                            rng.randn(B, Tk, KV, hd),
                            rng.randn(B, Tk, KV, hd), qp, kp)
    got = ops.flash_attention(q, k, v, qpt, kpt, window=window)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), qpt, kpt,
                                   window=window)
    assert ops.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    assert bool((got[1, -1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_stateful_model_on_card_matches_cpu(cuda, arch, paged):
    """Reduced mamba2 / recurrentgemma in fp32: chunked prefill (a ragged
    SSD chunk included) + decode through the kernels on the card gives the
    CPU plain path's logits."""
    from repro_torch.config.registry import get_config
    from repro_torch.models.model import build_model

    cfg = get_config(arch, "reduced")
    m_gpu = build_model(cfg, torch.float32, cuda)
    m_cpu = build_model(cfg, torch.float32, "cpu")
    p_cpu = m_cpu.init(0)

    def to(p, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in p.items()}

    toks = torch.randint(0, cfg.vocab_size, (2, 80),
                         generator=torch.Generator().manual_seed(0))
    pos = torch.arange(80, dtype=torch.int32)[None].repeat(2, 1)
    outs = []
    for m, p, dev in ((m_gpu, to(p_cpu, cuda), cuda), (m_cpu, p_cpu, "cpu")):
        if paged:
            cache = m.init_paged_cache(16, 16, n_slots=4)
            tables = torch.tensor([[0, 1, 2, 3, 4, -1], [9, 7, 5, 11, 6, -1]],
                                  dtype=torch.int32, device=dev)
            rows = torch.tensor([2, 0], device=dev)

            def step(t, q, c, dec):
                fn = m.decode_step_paged if dec else m.prefill_paged
                if dec:
                    lg, c = fn(p, t[:, 0], q[:, 0], tables, c, rows=rows)
                    return lg[:, None], c
                return fn(p, t, q, tables, c, rows=rows)
        else:
            cache = m.init_cache(2, 96, prefill_chunk=70)

            def step(t, q, c, dec):
                if dec:
                    lg, c = m.decode_step(p, t[:, 0], q[:, 0], c)
                    return lg[:, None], c
                return m.prefill(p, t, q, c)
        seq = []
        for s, e in ((0, 70), (70, 71), (71, 72), (72, 80)):
            lg, cache = step(toks[:, s:e].to(dev), pos[:, s:e].to(dev), cache,
                             e - s == 1)
            seq.append(lg.cpu())
        outs.append(torch.cat(seq, 1))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)
    used = ["rmsnorm", "add_rmsnorm", "ssd_intra"] \
        if arch == "mamba2-2.7b" else \
        ["rmsnorm", "add_rmsnorm", "rglru_gated_scan",
         "paged_flash_attention" if paged else "flash_attention",
         "paged_decode_attention" if paged else "decode_attention"]
    assert all(ops.LAUNCHES[k] > 0 for k in used), ops.LAUNCHES
    assert ops.LAUNCHES["rglru_scan"] == 0, ops.LAUNCHES


# ---------------------------------------------------------------------------
# paged attention on the tensor-core kernel (bf16): the block-table walk for
# decode (Tq = 1) and for chunks, against the fp32 plain versions at
# atol = rtol = 2e-2


def _paged_bf16(dev, rng, Tq, H, KV, hd, bs, lens, q_ends, window=0,
                holes=()):
    """Rows of `lens` tokens in the pools (MB blocks of bs, the table
    rounded up to whole 64-key tiles plus one); each row's Tq queries end
    at q_ends[b] (-1: a padding row, every query at position -1)."""
    MB = -(-max(lens) // bs) + 64 // bs
    kp, vp, kpos, tables = _paged_pools(rng, lens, bs, MB, KV, hd, holes)
    B = len(lens)
    qp = np.stack([np.arange(e - Tq, e) if e >= 0 else np.full(Tq, -1)
                   for e in q_ends]).astype(np.int32)
    q = rng.randn(B, Tq, H, hd)
    args = _on(dev, q, kp, vp, qp, kpos, tables)
    f32 = [a.float() for a in args[:3]] + args[3:]
    if Tq == 1:
        got = ops.paged_decode_attention(args[0][:, 0], *args[1:3],
                                         args[3][:, 0], *args[4:],
                                         window=window)[:, None]
        want = ref.paged_decode_attention_ref(f32[0][:, 0], *f32[1:3],
                                              f32[3][:, 0], *f32[4:],
                                              window=window)[:, None]
        assert ops.LAUNCHES["paged_decode_attention"] == 1
    else:
        got = ops.paged_flash_attention(*args, window=window)
        want = ref.paged_flash_attention_ref(*f32, window=window)
        assert ops.LAUNCHES["paged_flash_attention"] == 1
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("G", [1, 4, 16])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_paged_decode_bf16_on_card(cuda, hd, G, bs, window):
    """Rows of 700, 351 and 41 tokens (ragged last blocks; a -1 hole in the
    middle of the first row's table) and a padding row with no visible
    key, which comes out exactly 0."""
    lens = [700, 351, 41, 5]
    got = _paged_bf16(cuda, np.random.RandomState(5), 1, 2 * G, 2, hd, bs,
                      lens, [700, 351, 41, -1], window=window,
                      holes={(0, 3)})
    assert bool((got[3] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("Tq", [2, 16, 17, 63, 500])
def test_paged_flash_bf16_chunk_lengths_on_card(cuda, Tq, window):
    """Chunks of Tq tokens (G 4 heads each) through the block table: one
    ends at 600 in a row filled to it, one starts its row (blocks of 16,
    a hole in the middle of its table)."""
    _paged_bf16(cuda, np.random.RandomState(6), Tq, 8, 2, 128, 16,
                [600, max(Tq, 40)], [600, max(Tq, 40)], window=window,
                holes={(1, 1)})


@pytest.mark.cuda
@pytest.mark.parametrize("n_splits", [1, 2, 4, 8])
def test_paged_decode_bf16_forced_splits_on_card(cuda, monkeypatch,
                                                 n_splits):
    """A ragged serving batch (1 to 1024 tokens a row, granite's heads) at
    each forced split count: splits that own only empty slots of a short
    row, and the combine pass, leave the result unchanged."""
    from repro_torch.kernels import split

    monkeypatch.setattr(split, "num_splits",
                        lambda B, KV, rt, kt, sms: min(n_splits, kt))
    lens = [1024, 1000, 777, 512, 301, 160, 33, 1]
    _paged_bf16(cuda, np.random.RandomState(7), 1, 32, 8, 128, 16, lens,
                lens)


@pytest.mark.cuda
def test_paged_decode_bf16_matches_contiguous_kernel_on_card(cuda):
    """The paged walk and the contiguous kernel on the same rows (the
    gathered view) give the same bf16 output up to summation order."""
    rng = np.random.RandomState(8)
    lens = [1024, 300, 17]
    kp, vp, kpos, tables = _paged_pools(rng, lens, 16, 64, 8, 128)
    q = rng.randn(3, 32, 128)
    qp = np.array(lens, np.int32) - 1
    args = _on(cuda, q, kp, vp, qp, kpos, tables)
    paged = ops.paged_decode_attention(*args)
    k, v, kposv = ref.paged_view(*args[1:3], args[4], args[5])
    contiguous = ops.decode_attention(args[0], k, v, args[3], kposv)
    torch.testing.assert_close(paged.float(), contiguous.float(), rtol=1e-2,
                               atol=1e-2)


# ---------------------------------------------------------------------------
# the other decoder-only families' head layouts at hd 128 (bf16):
# starcoder2-7b's G 9 on 4 kv heads, qwen1.5-32b's MHA on 40, and
# mistral-nemo-12b's sliding window on a wrapped ring

FAMILY_HEADS = [(36, 4), (40, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("H,KV", FAMILY_HEADS, ids=["G9", "KV40"])
def test_decode_bf16_family_heads_on_card(cuda, H, KV):
    """Contiguous and paged decode, rows filled to 1024 / 700 / 351 / 41
    of 1024 slots."""
    lens = [1024, 700, 351, 41]
    ar = np.arange(1024)[None]
    q_pos = np.array(lens) - 1
    _decode_bf16(cuda, np.random.RandomState(11), 1024, H, KV, 128, q_pos,
                 np.where(ar <= q_pos[:, None], ar, -1))
    ops.reset_launches()
    _paged_bf16(cuda, np.random.RandomState(12), 1, H, KV, 128, 16, lens,
                lens)


@pytest.mark.cuda
@pytest.mark.parametrize("Tq", [16, 17])
@pytest.mark.parametrize("H,KV", FAMILY_HEADS, ids=["G9", "KV40"])
def test_chunk_bf16_family_heads_on_card(cuda, H, KV, Tq):
    """A chunk of Tq tokens ending at 600 in a row filled to it, contiguous
    and through the block table."""
    rng = np.random.RandomState(13)
    Tk, end = 1024, 600
    qp = np.arange(end - Tq, end, dtype=np.int32)[None]
    kp = np.where(np.arange(Tk) < end, np.arange(Tk), -1)[None]
    q, k, v, qpt, kpt = _on(cuda, rng.randn(1, Tq, H, 128),
                            rng.randn(1, Tk, KV, 128),
                            rng.randn(1, Tk, KV, 128), qp, kp.astype(np.int32))
    got = ops.flash_attention(q, k, v, qpt, kpt)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), qpt, kpt)
    assert ops.LAUNCHES["flash_attention"] == 1
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    _paged_bf16(cuda, rng, Tq, H, KV, 128, 16, [end], [end])


@pytest.mark.cuda
@pytest.mark.parametrize("Tq", [1, 16])
def test_wrapped_ring_bf16_on_card(cuda, Tq):
    """mistral-nemo's sliding variant (32 heads on 8, window 256) on the
    ring of 256 + 16 - 1 = 271 slots that a 16-token chunk needs: rows'
    last queries at 1100-1211, every slot holding the newest position of
    its residue; decode (Tq 1) and a chunk."""
    rng = np.random.RandomState(14)
    B, S, H, KV, hd, window = 4, 271, 32, 8, 128, 256
    last = 1100 + 37 * np.arange(B)
    kp = (last[:, None] - (last[:, None] - np.arange(S)) % S).astype(np.int32)
    qp = (last[:, None] - Tq + 1 + np.arange(Tq)).astype(np.int32)
    q, k, v, qpt, kpt = _on(cuda, rng.randn(B, Tq, H, hd),
                            rng.randn(B, S, KV, hd), rng.randn(B, S, KV, hd),
                            qp, kp)
    f32 = (q.float(), k.float(), v.float(), qpt, kpt)
    if Tq == 1:
        got = ops.decode_attention(q[:, 0], k, v, qpt[:, 0], kpt,
                                   window=window)
        want = ref.decode_attention_ref(f32[0][:, 0], *f32[1:3], qpt[:, 0],
                                        kpt, window=window)
    else:
        got = ops.flash_attention(q, k, v, qpt, kpt, window=window)
        want = ref.flash_attention_ref(*f32, window=window)
    assert ops.LAUNCHES["decode_attention" if Tq == 1
                        else "flash_attention"] == 1
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_moe_apply_bf16_on_card_matches_cpu(cuda):
    """The MoE layer at reduced qwen2-moe widths in bf16 on the card (its
    router in fp32) against the fp32 CPU version on the same weights: the
    same experts picked, the output within 2e-2."""
    from repro_torch.config.registry import get_config
    from repro_torch.models import layers as L

    cfg = get_config("qwen2-moe-a2.7b", "reduced")
    p = L.init_moe(L.ParamInit(0, torch.bfloat16, cuda), cfg, 1)
    p = {k: v[0] if not isinstance(v, dict) else {n: w[0] for n, w
                                                   in v.items()}
         for k, v in p.items()}
    x = torch.randn(3, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16)

    def cpu(t):
        return {k: cpu(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.float().cpu()

    K = cfg.moe.num_experts_per_tok
    _, picked = L.top_k(torch.softmax(x.to(cuda).float() @ p["router"], -1),
                        K)
    _, want_picked = L.top_k(torch.softmax(x.float() @ p["router"].cpu(),
                                           -1), K)
    assert torch.equal(picked.cpu(), want_picked)
    for no_drop in (True, False):
        got, aux = L.moe_apply(p, x.to(cuda), cfg, no_drop=no_drop,
                               group_size=16)
        want, aux_w = L.moe_apply(cpu(p), x.float(), cfg, no_drop=no_drop,
                                  group_size=16)
        torch.testing.assert_close(got.float().cpu(), want, rtol=2e-2,
                                   atol=2e-2)
        torch.testing.assert_close(aux.cpu(), aux_w, rtol=1e-3, atol=1e-6)


# ---------------------------------------------------------------------------
# RMSNorm in CUDA C++, with and without the fused residual add


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048, 2560, 4096, 4608, 5120])
@pytest.mark.parametrize("rows", [1, 8, 4096])
def test_add_rmsnorm_bf16_on_card(cuda, rows, d):
    """The fused sum is bit for bit PyTorch's bf16 `x + y`; both norms are
    within 2e-2 of the fp32 plain version of the norm of that sum."""
    rng = np.random.RandomState(9)
    x, y, w = _on(cuda, rng.randn(rows, d), rng.randn(rows, d),
                  rng.randn(d) * 0.1)
    s, h = ops.add_rmsnorm(x, y, w)
    assert torch.equal(s, x + y)
    want = ref.rmsnorm_ref(s.float(), w.float())
    torch.testing.assert_close(h.float(), want, rtol=2e-2, atol=2e-2)
    h1 = ops.rmsnorm(s, w)
    torch.testing.assert_close(h1.float(), want, rtol=2e-2, atol=2e-2)
    assert ops.LAUNCHES["add_rmsnorm"] == 1 and ops.LAUNCHES["rmsnorm"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [130, 4096, 5120])
def test_add_rmsnorm_fp32_on_card(cuda, d):
    """fp32, as the on-card model tests run it, at a width that takes one
    element a load (130) and two that take 16-byte loads."""
    rng = np.random.RandomState(10)
    x, y, w = _on(cuda, rng.randn(5, 3, d), rng.randn(5, 3, d),
                  rng.randn(d) * 0.1, dtype=torch.float32)
    s, h = ops.add_rmsnorm(x, y, w)
    assert torch.equal(s, x + y)
    torch.testing.assert_close(h, ref.rmsnorm_ref(x + y, w), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the compiled serving step: CUDA graph replays against eager runs of the
# same steps, reduced models of the three families in both cache layouts

GRAPH_FAMILIES = ("granite-3-8b", "mamba2-2.7b", "recurrentgemma-9b",
                  "qwen2-moe-a2.7b")
GRAPH_COUNTERS = ("decode_steps", "mean_batch", "admitted", "preemptions",
                  "prefill_tokens", "finished", "copy_rows")


def _graph_engine(dev, arch, paged, cuda_graphs, depth=0, group=None):
    """Reduced fp32 engine on the card: static admission (batches of up to
    4, so decode moves between buckets) and chunked prefill on 2 lanes,
    `depth` intervals dispatched ahead (DESIGN §14); with `group`, on its
    mesh (DESIGN §12)."""
    from repro_torch.config.base import ServeConfig
    from repro_torch.config.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine

    m = build_model(get_config(arch, "reduced"), torch.float32, dev,
                    group=group)
    serve = ServeConfig(policy="static", b_max=4, max_new_tokens=6,
                        kv_pool_tokens=1024, block_size=8,
                        chunked_prefill=True, chunk_budget_tokens=16,
                        n_prefill_lanes=2, paged_kv=paged,
                        overlap_depth=depth,
                        mesh_shape=group.mesh_shape if group else ())
    return Engine(m, m.init(0), serve, max_context=64, buckets=(1, 2, 4),
                  prefill_chunk=8, device=dev, cuda_graphs=cuda_graphs)


def _fill_engine_cache(eng, seed=0):
    """Random K/V, positions and state everywhere a request could look (the
    paged spare block's positions stay empty, the sentinel state zero)."""
    from repro_torch.models.backbone import STATE_KEYS

    g = torch.Generator(device=eng.device).manual_seed(seed)
    for k, v in eng.cache.items():
        if k == "pos":
            v.copy_(torch.randint(-1, 60, v.shape, generator=g,
                                  device=eng.device, dtype=v.dtype))
            if eng.paged:
                v[-1] = -1
        else:
            v.normal_(generator=g)
            if eng.paged and k in STATE_KEYS:
                v[:, eng.n_slots] = 0


def _stage_random(eng, st, rng):
    """Real-looking inputs for step `st`: tokens, positions up to 56,
    distinct blocks per row and distinct state slots (paged)."""
    rows, T = st.inputs["tokens"].shape
    starts = rng.randint(T, 56 - T, size=rows)
    host = {"tokens": rng.randint(0, eng.cfg.vocab_size, (rows, T)),
            "positions": starts[:, None] + np.arange(T)}
    if eng.paged:
        blocks = rng.permutation(eng.mem.num_blocks)
        per = eng.max_blocks
        host["block_table"] = blocks[:rows * per].reshape(rows, per)
        host["slots"] = rng.permutation(eng.n_slots)[:rows]
    for k, v in host.items():
        eng._stage(st, k, v.astype(np.int64))


def _served(eng, prompts):
    hs = [eng.submit(p) for p in prompts]
    eng.run(max_steps=2000)
    return [h.output_tokens for h in hs], eng.summary()


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", GRAPH_FAMILIES)
def test_graph_engine_equals_eager_engine_on_card(cuda, arch, paged):
    """Served with graph replays and with the same steps run eagerly: the
    same tokens and counters, over promotions from both lanes, no
    preemption and decode in more than one bucket; every decode step and
    chunk of the graph run was a replay."""
    rng = np.random.RandomState(3)
    prompts = [list(map(int, rng.randint(0, 256, size=n)))
               for n in (5, 21, 9, 30, 13, 17)]
    runs = []
    for graphs in (True, False):
        eng = _graph_engine(cuda, arch, paged, graphs)
        if graphs:
            eng.warmup()
        runs.append((eng, *_served(eng, prompts)))
    (g_eng, g_toks, g_sum), (e_eng, e_toks, e_sum) = runs
    assert g_toks == e_toks
    assert {k: g_sum[k] for k in GRAPH_COUNTERS} \
        == {k: e_sum[k] for k in GRAPH_COUNTERS}
    assert g_sum["finished"] == len(prompts) and g_sum["preemptions"] == 0
    assert len({min(b for b in g_eng.buckets if b >= n)
                for n in g_eng.batch_trace}) > 1
    assert g_eng.graphs.captures == len(g_eng.graphs.steps) > 0
    assert e_eng.graphs.captures == 0
    assert all(st.graph is not None for st in g_eng.graphs.steps.values())


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", GRAPH_FAMILIES)
def test_replay_equals_eager_bit_for_bit_on_card(cuda, arch, paged):
    """At every decode bucket and on a lane chunk: the replay's logits and
    the cache it leaves are the eager run's, bit for bit, from the same
    cache and inputs; and the replay adds the captured launches."""
    eng = _graph_engine(cuda, arch, paged, True)
    eng.warmup()
    rng = np.random.RandomState(0)
    lane = ("chunk", 1, 8, -1 if paged else eng.max_slots)
    for key in [("decode", b) for b in eng.buckets] + [lane]:
        st = eng.graphs.steps[key]
        _fill_engine_cache(eng, seed=len(key))
        _stage_random(eng, st, rng)
        start = {k: v.clone() for k, v in eng.cache.items()}
        want = st.run(eager=True).clone()
        want_cache = {k: v.clone() for k, v in eng.cache.items()}
        for k, v in start.items():
            eng.cache[k].copy_(v)
        before = dict(ops.LAUNCHES)
        got = st.run().clone()
        assert torch.equal(got, want), key
        for k, v in eng.cache.items():
            assert torch.equal(v, want_cache[k]), (key, k)
        assert st.launches and all(
            ops.LAUNCHES[k] - before[k] == n for k, n in st.launches.items())


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", GRAPH_FAMILIES)
def test_warmup_changes_no_visible_slot_on_card(cuda, arch, paged):
    """`warmup` (eager runs and captures of every all-padding step) leaves
    every K/V slot, position and state row as it was; only the paged spare
    block takes writes."""
    eng = _graph_engine(cuda, arch, paged, True)
    _fill_engine_cache(eng)
    before = {k: v.clone() for k, v in eng.cache.items()}
    eng.warmup()
    torch.cuda.synchronize()
    assert eng.graphs.captures == len(eng.graphs.steps) \
        == (5 if paged else 6)
    for k, v in eng.cache.items():
        got, was = (v[:, :-1], before[k][:, :-1]) \
            if paged and k in ("k", "v") else (v, before[k])
        assert torch.equal(got, was), k


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", GRAPH_FAMILIES)
def test_overlap_engine_equals_depth0_on_card(cuda, arch, paged, monkeypatch):
    """On graphs, two intervals dispatched ahead give the synchronous
    loop's tokens, step count and counters bit for bit; every retirement
    waits on its own record's event, recorded behind the readback copy
    into pinned memory; and at depth 2 a record retires only behind two
    later dispatched intervals (but in the final drain)."""
    from repro_torch.serving.engine import Engine

    rng = np.random.RandomState(3)
    prompts = [list(map(int, rng.randint(0, 256, size=n)))
               for n in (5, 21, 9, 30, 13, 17)]
    waits, recs = [], []
    retire = Engine._retire_step
    event_sync = torch.cuda.Event.synchronize

    def spy_retire(self):
        rec = self._inflight[0]
        assert rec.event is not None and rec.host.is_pinned()
        recs.append((rec.event, self.overlap_depth, len(self._inflight)))
        return retire(self)

    def spy_event(ev):
        waits.append(ev)
        return event_sync(ev)

    monkeypatch.setattr(Engine, "_retire_step", spy_retire)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", spy_event)
    runs = {}
    for depth in (0, 2):
        eng = _graph_engine(cuda, arch, paged, True, depth=depth)
        eng.warmup()
        hs = [eng.submit(p) for p in prompts]
        steps = eng.run(max_steps=2000)
        runs[depth] = (steps, [h.output_tokens for h in hs], eng.summary())
        assert not eng._inflight
    (s0, t0, m0), (s2, t2, m2) = runs[0], runs[2]
    assert (s2, t2) == (s0, t0)
    assert {k: m2[k] for k in GRAPH_COUNTERS} \
        == {k: m0[k] for k in GRAPH_COUNTERS}
    assert [ev for ev, _, _ in recs] == waits
    deep = [n for _, d, n in recs if d == 2]
    assert deep.count(3) == len(deep) - 2 and deep[-2:] == [2, 1]


# ---------------------------------------------------------------------------
# the memory tiers on the card (DESIGN §10, §11)


def _watch_round_trips(eng):
    """Wrap `_swap_out` / `_swap_in_next` from outside: the victim's K, V
    and pos pool rows at swap-out, and the rows at its new blocks after
    the swap-in. Returns the list of (taken, restored) pairs."""
    taken, pairs = {}, []
    swap_out, swap_in = eng._swap_out, eng._swap_in_next

    def rows(ids):
        idx = torch.tensor(ids, device=eng.device)
        return {k: eng.cache[k].index_select(0 if k == "pos" else 1,
                                             idx).clone()
                for k in ("k", "v", "pos")}

    def out_spy(slot, r):
        taken[r.rid] = rows(eng.blocks.table(r.rid))
        swap_out(slot, r)

    def in_spy():
        rid = eng.swapped[0].rid
        ok = swap_in()
        if ok:
            pairs.append((taken.pop(rid), rows(eng.blocks.table(rid))))
        return ok

    eng._swap_out, eng._swap_in_next = out_spy, in_spy
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 2])
def test_full_width_swap_round_trip_on_card(cuda, depth):
    """granite-3-8b at full width, bf16, on CUDA graphs, forced swap under
    a 1536-token pool (chip_smoke's 12 prompts): every swap-in restores
    the swapped-out K, V and pos rows bit for bit, the host pool is
    pinned and ends full, and every request finishes."""
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args([
        "--variant", "full", "--policy", "static", "--b-max", "8",
        "--batch-buckets", "1,2,4,8", "--chunked", "--lanes", "2",
        "--chunk-budget", "512", "--max-context", "1024", "--paged",
        "--pool-tokens", "1536", "--swap-space", "256", "--preempt", "swap",
        "--max-new", "32", "--overlap-depth", str(depth)])
    from repro_torch.bench.kv_swap import prompts

    eng = serve.build_engine(args)
    assert all(t.is_pinned() for t in eng._host_pool.values())
    pairs = _watch_round_trips(eng)
    for p in prompts(eng.cfg.vocab_size):
        eng.submit(p)
    eng.run()
    torch.cuda.synchronize()
    assert eng.total_finished == 12 and eng.swap_outs > 0
    assert len(pairs) == eng.swap_ins == eng.swap_outs
    for taken, restored in pairs:
        for k in taken:
            assert torch.equal(taken[k], restored[k]), k
    assert eng.blocks.host_free_blocks == 256
    assert eng.blocks.free_blocks == eng.blocks.num_blocks


def _tier_engine(dev, params, prefix, swap):
    """Reduced granite (fp32) on the paged pool of 10 blocks, chunked on two
    lanes, with prefix sharing or forced swap; on the card on CUDA graphs
    captured first."""
    from repro_torch.config.base import ServeConfig
    from repro_torch.config.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine

    m = build_model(get_config("granite-3-8b", "reduced"), torch.float32,
                    dev)
    serve = ServeConfig(policy="static", b_max=4, max_new_tokens=12,
                        kv_pool_tokens=160, block_size=16,
                        chunked_prefill=True, chunk_budget_tokens=16,
                        n_prefill_lanes=2, paged_kv=True,
                        prefix_cache=prefix,
                        swap_space_blocks=32 if swap else 0,
                        preempt="swap" if swap else "auto")
    eng = Engine(m, params, serve, max_context=96, buckets=(1, 2, 4),
                 prefill_chunk=8, device=dev)
    if eng.graphs.enabled:
        eng.warmup()
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["prefix", "swap"])
def test_tier_engine_on_card_matches_cpu(cuda, tier):
    """Reduced granite in fp32, the same weights on the card (CUDA graphs,
    the port's kernels) and on the CPU: with prefix sharing on over a
    shared system prompt, or with swap forced under a tight pool, the
    same tokens and the same tier counters."""
    from repro_torch.config.registry import get_config
    from repro_torch.models.model import build_model

    p_cpu = build_model(get_config("granite-3-8b", "reduced"),
                        torch.float32, "cpu").init(0)

    def to(p, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in p.items()}

    rng = np.random.RandomState(5)
    system = list(map(int, rng.randint(0, 256, size=40)))
    prompts = [system + list(map(int, rng.randint(0, 256, size=4 + 2 * i)))
               if tier == "prefix"
               else list(map(int, rng.randint(0, 256, size=n)))
               for i, n in enumerate((40, 44, 38, 46))]
    runs = []
    for dev, p in ((cuda, to(p_cpu, cuda)), ("cpu", p_cpu)):
        eng = _tier_engine(dev, p, tier == "prefix", tier == "swap")
        hs = [eng.submit(t, arrival_time=0.0) for t in prompts]
        eng.run(max_steps=5000)
        s = eng.summary()
        runs.append(([h.output_tokens for h in hs], {k: s[k] for k in (
            "finished", "preemptions", "swap_outs", "swap_ins",
            "prefix_hit_tokens", "copy_bytes", "decode_steps")}))
    assert runs[0] == runs[1]
    _, c = runs[0]
    assert c["finished"] == 4
    assert (c["prefix_hit_tokens"] > 0) if tier == "prefix" \
        else (c["swap_outs"] > 0 and c["swap_ins"] == c["swap_outs"])
    assert ops.LAUNCHES["paged_decode_attention"] > 0
    assert ops.LAUNCHES["decode_attention"] == 0


@pytest.mark.cuda
def test_replay_after_swap_in_equals_eager_on_card(cuda):
    """Right after the interval that swapped a request back in, the decode
    step it ran (its staged inputs as they stand) replays bit for bit as
    it runs eagerly, logits and cache, from the same cache."""
    from repro_torch.config.registry import get_config
    from repro_torch.models.model import build_model

    m = build_model(get_config("granite-3-8b", "reduced"), torch.float32,
                    cuda)
    eng = _tier_engine(cuda, m.init(0), False, True)
    rng = np.random.RandomState(0)
    for n in (40, 44, 38, 46):
        eng.submit(list(map(int, rng.randint(0, 256, size=n))),
                   arrival_time=0.0)
    while eng.swap_ins == 0:
        assert eng.step()
    torch.cuda.synchronize()
    n = eng.batch_trace[-1]          # the rows of the interval's decode
    st = eng.graphs.steps[("decode", min(b for b in eng.buckets if b >= n))]
    assert st.graph is not None
    start = {k: v.clone() for k, v in eng.cache.items()}
    want = st.run(eager=True).clone()
    want_cache = {k: v.clone() for k, v in eng.cache.items()}
    for k, v in start.items():
        eng.cache[k].copy_(v)
    got = st.run().clone()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for k, v in eng.cache.items():
        assert torch.equal(v, want_cache[k]), k
    eng.run(max_steps=5000)
    assert eng.total_finished == 4


# ---------------------------------------------------------------------------
# the VLM and enc-dec families: non-causal attention (the encoder, the
# cross-attention reads), the paged cross read, the reduced models


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Tq,Tk,H,KV,hd,enc", [
    (1, 1024, 1024, 16, 16, 64, True),     # seamless's encoder
    (1, 16, 1024, 16, 16, 64, False),      # its cross chunk
    (8, 1, 1024, 16, 16, 64, False),       # its cross decode
    (2, 40, 1024, 16, 16, 64, True),       # Tq * G > 16 at hd 64, ragged
    (8, 1, 1601, 64, 8, 128, False),       # the VLM's cross decode
    (1, 16, 1601, 64, 8, 128, False),      # its cross chunk
    (1, 1601, 1601, 8, 8, 64, True)])      # Tq = Tk = 1601, both tails
def test_flash_noncausal_on_card(cuda, dtype, B, Tq, Tk, H, KV, hd, enc):
    """Non-causal flash attention at the cross families' shapes: every key
    visible, as the encoder (positions 0..Tk-1) or a cross read (all at
    position 0) calls it."""
    rng = np.random.RandomState(7)
    if enc:
        qp = np.tile(np.arange(Tq, dtype=np.int32), (B, 1))
        kp = np.tile(np.arange(Tk, dtype=np.int32), (B, 1))
    else:
        qp = np.zeros((B, Tq), np.int32)
        kp = np.zeros((B, Tk), np.int32)
    dt = getattr(torch, dtype)
    q, k, v, qpt, kpt = _on(cuda, rng.randn(B, Tq, H, hd),
                            rng.randn(B, Tk, KV, hd),
                            rng.randn(B, Tk, KV, hd), qp, kp, dtype=dt)
    got = ops.flash_attention(q, k, v, qpt, kpt, causal=False)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), qpt,
                                   kpt, causal=False)
    assert ops.LAUNCHES["flash_attention"] == 1
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Tq,S,H,KV,hd", [(1, 1024, 16, 16, 64),
                                          (16, 1024, 16, 16, 64),
                                          (1, 1601, 64, 8, 128),
                                          (16, 1601, 64, 8, 128)])
def test_paged_cross_read_on_card(cuda, dtype, Tq, S, H, KV, hd):
    """The paged cross read: each row's cross K/V is one block of S slots
    of the per-slot rows (tables = rows.view(B, 1)), positions all 0, a
    padding row on the zero sentinel slot; equal to the contiguous kernel
    on the gathered rows (bf16) and to the plain version."""
    rng = np.random.RandomState(8)
    N, rows = 6, np.array([3, 0, 5, 2], np.int64)   # 5: the sentinel
    B = len(rows)
    kp, vp = rng.randn(2, N, S, KV, hd)
    kp[5] = vp[5] = 0
    dt = getattr(torch, dtype)
    q, kpool, vpool, qp, kpos, r = _on(
        cuda, rng.randn(B, Tq, H, hd), kp, vp, np.zeros((B, Tq), np.int32),
        np.zeros((N, S), np.int32), rows, dtype=dt)
    got = ops.paged_flash_attention(q, kpool, vpool, qp, kpos, r.view(B, 1),
                                    causal=False)
    want = ref.paged_flash_attention_ref(q.float(), kpool.float(),
                                         vpool.float(), qp, kpos,
                                         r.view(B, 1), causal=False)
    assert ops.LAUNCHES["paged_flash_attention"] == 1
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    assert bool((got[2] == 0).all())
    if dt == torch.bfloat16:
        # the paged walk is the contiguous walk of the same (mma.sync)
        # kernel: a 16-token chunk of the VLM's 128 rows routes to the
        # wgmma kernel when contiguous, and blocks of 1601 do not box
        from repro_torch.kernels.flash_attention import flash_attention_cuda
        flat = flash_attention_cuda(q, kpool[r], vpool[r], qp,
                                    torch.zeros((B, S), dtype=torch.int32,
                                                device=cuda), causal=False,
                                    _kernel="mma")
        torch.testing.assert_close(got, flat, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,Tk,H,KV,hd,causal,window,fill,empty_row", [
    (1, 1024, 1024, 16, 16, 64, False, 0, 1024, False),  # the encoder
    (1, 500, 1024, 32, 8, 128, True, 0, 496, False),     # granite Tq 500
    (1, 256, 1024, 8, 4, 64, True, 100, 900, False),     # a sliding window
    (2, 64, 1024, 36, 4, 128, True, 0, 700, False),      # G 9 straddles
    (1, 16, 1601, 64, 8, 128, False, 0, 1601, False),    # ragged, split
    (2, 200, 512, 4, 4, 64, True, 0, 400, True),         # a row sees none
])
def test_wgmma_flash_kernel_on_card(cuda, B, Tq, Tk, H, KV, hd, causal,
                                    window, fill, empty_row):
    """The long-row kernel (wgmma over a TMA ring) on the calls it is
    routed: bf16 against the fp32 plain version at atol = rtol = 2e-2; each
    row's last query at position fill - 1 (causal) over slots filled to
    `fill` (-1 past it); a row whose slots are all empty comes out exactly
    0. One launch a call, counted under the entry and under its wgmma
    key; the VLM's Tq-16 cross chunk (8 blocks) splits its key tiles."""
    from repro_torch.kernels import split
    rng = np.random.RandomState(30)
    ar = np.arange(Tk, dtype=np.int32)
    kp = np.tile(np.where(ar < fill, ar, -1), (B, 1))
    if empty_row:
        kp[0] = -1
    qp = np.tile(np.arange(fill - Tq, fill, dtype=np.int32) if causal
                 else np.arange(Tq, dtype=np.int32), (B, 1))
    q, k, v, qpt, kpt = _on(cuda, rng.randn(B, Tq, H, hd),
                            rng.randn(B, Tk, KV, hd),
                            rng.randn(B, Tk, KV, hd), qp, kp)
    rows = Tq * (H // KV)
    assert split.route(q.dtype, hd, rows, Tk) == "wgmma"
    got = ops.flash_attention(q, k, v, qpt, kpt, window=window, causal=causal)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), qpt, kpt,
                                   window=window, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == 1
    assert ops.LAUNCHES["flash_attention_wgmma"] == 1
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    if empty_row:
        assert bool((got[0] == 0).all())
    if Tk == 1601:
        assert split.launch_splits("wgmma", B, KV, rows, Tk, hd,
                                   split.sm_count(cuda.index or 0)) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("Tq,H,KV,hd,bs,lens,holes", [
    (500, 32, 8, 128, 16, [496, 301], {(1, 3)}),  # granite Tq 500, bs 16
    (300, 8, 8, 64, 128, [700], set()),           # blocks of 128
    (200, 16, 4, 64, 32, [333, 64], {(0, 5)}),    # blocks of 32: 2 boxes
])
def test_wgmma_paged_flash_kernel_on_card(cuda, Tq, H, KV, hd, bs, lens,
                                          holes):
    """The long-row kernel through the block table: shuffled physical
    blocks, -1 table tails and holes (a box with no block is zeroed, its
    slots empty), a stale block no table names; against the fp32 plain
    version and one launch a call."""
    from repro_torch.kernels import split
    rng = np.random.RandomState(31)
    MB = -(-1024 // bs)
    kp, vp, kpos, tables = _paged_pools(rng, lens, bs, MB, KV, hd, holes)
    B = len(lens)
    qp = np.stack([np.arange(n - Tq, n, dtype=np.int32) for n in lens])
    q, kpool, vpool, qpt, kpt, tbl = _on(cuda, rng.randn(B, Tq, H, hd), kp,
                                         vp, qp, kpos, tables)
    assert split.route(q.dtype, hd, Tq * (H // KV), MB * bs, bs) == "wgmma"
    got = ops.paged_flash_attention(q, kpool, vpool, qpt, kpt, tbl)
    want = ref.paged_flash_attention_ref(q.float(), kpool.float(),
                                         vpool.float(), qpt, kpt, tbl)
    assert ops.LAUNCHES["paged_flash_attention"] == 1
    assert ops.LAUNCHES["paged_flash_attention_wgmma"] == 1
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_wgmma_kernel_refuses_what_it_cannot_run(cuda):
    """Named on a call it cannot run (hd 256, fp32, a block size it cannot
    box), the wgmma kernel raises; nothing falls back."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, paged_flash_attention_cuda)
    z = torch.zeros
    i32 = dict(dtype=torch.int32, device=cuda)
    for hd, dt in ((256, torch.bfloat16), (64, torch.float32)):
        q = z((1, 128, 1, hd), dtype=dt, device=cuda)
        kv = z((1, 256, 1, hd), dtype=dt, device=cuda)
        with pytest.raises(ValueError):
            flash_attention_cuda(q, kv, kv, z((1, 128), **i32),
                                 z((1, 256), **i32), _kernel="wgmma")
    q = z((1, 128, 1, 64), dtype=torch.bfloat16, device=cuda)
    pool = z((4, 100, 1, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        paged_flash_attention_cuda(q, pool, pool, z((1, 128), **i32),
                                   z((4, 100), **i32), z((1, 2), **i32),
                                   _kernel="wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["seamless-m4t-medium",
                                  "llama-3.2-vision-90b"])
def test_cross_model_on_card_matches_cpu(cuda, arch, paged):
    """The reduced VLM and enc-dec models in fp32, gates at 0.5: a first
    chunk with extras (16 frames or patches), more chunks, decode, through
    the kernels on the card, give the CPU plain path's logits."""
    from repro_torch.config.registry import get_config
    from repro_torch.models.backbone import extras_key
    from repro_torch.models.model import build_model

    cfg = get_config(arch, "reduced")
    m_gpu = build_model(cfg, torch.float32, cuda)
    m_cpu = build_model(cfg, torch.float32, "cpu")
    p_cpu = m_cpu.init(0)
    for key in ("cross_layers", "dec_cross"):
        if key in p_cpu:
            p_cpu[key]["attn"]["gate"].fill_(0.5)

    def to(p, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in p.items()}

    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 30), generator=g)
    pos = torch.arange(30, dtype=torch.int32)[None].repeat(2, 1)
    extras = torch.randn((2, 16, cfg.d_model), generator=g)
    outs = []
    for m, p, dev in ((m_gpu, to(p_cpu, cuda), cuda), (m_cpu, p_cpu, "cpu")):
        rows = torch.tensor([2, 0], device=dev)
        if paged:
            cache = m.init_paged_cache(8, 16, n_slots=3, enc_len=16)
            tables = torch.tensor([[0, 1, -1, -1], [5, 3, -1, -1]],
                                  dtype=torch.int32, device=dev)
        else:
            cache = m.init_cache(2, 64, enc_len=16)
        seq = []
        for s, e in ((0, 24), (24, 25), (25, 26), (26, 30)):
            ex = {extras_key(cfg): extras.to(dev)} if s == 0 else None
            t, q = toks[:, s:e].to(dev), pos[:, s:e].to(dev)
            lg, cache = m.prefill_paged(p, t, q, tables, cache, rows=rows,
                                        extras=ex) if paged \
                else m.prefill(p, t, q, cache, extras=ex)
            seq.append(lg.cpu())
        outs.append(torch.cat(seq, 1))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)
    attn = "paged_flash_attention" if paged else "flash_attention"
    assert ops.LAUNCHES[attn] > 0 and ops.LAUNCHES["add_rmsnorm"] > 0
    if paged:
        # the encoder's own attention is the only contiguous launch
        assert ops.LAUNCHES["flash_attention"] \
            == cfg.encoder_layers, ops.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
def test_cross_engine_on_graphs_matches_eager_on_card(cuda, paged):
    """The reduced enc-dec engine with extras on CUDA graphs gives the
    eager engine's tokens and counters (the extras step replays its
    staged input; warmup's captures keep every live cross row)."""
    from repro_torch.config.base import ServeConfig
    from repro_torch.config.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine

    m = build_model(get_config("seamless-m4t-medium", "reduced"),
                    torch.float32, cuda)
    p = m.init(0)
    rng = np.random.RandomState(2)
    prompts = [list(map(int, rng.randint(0, 256, size=n)))
               for n in (20, 9, 33, 16)]
    extras = [{"enc_frames": rng.randn(1, 16, m.cfg.d_model)}
              for _ in prompts]
    runs = []
    for graphs in (True, False):
        serve = ServeConfig(policy="memory", b_max=4, max_new_tokens=6,
                            kv_pool_tokens=1024, chunked_prefill=True,
                            chunk_budget_tokens=16, n_prefill_lanes=2,
                            paged_kv=paged)
        eng = Engine(m, p, serve, max_context=64, buckets=(1, 2, 4),
                     prefill_chunk=8, enc_len=16, device=cuda,
                     cuda_graphs=graphs)
        if graphs:
            eng.warmup()
        hs = [eng.submit(t, extras=x) for t, x in zip(prompts, extras)]
        eng.run(max_steps=5000)
        s = eng.summary()
        runs.append(([h.output_tokens for h in hs],
                     {k: s[k] for k in ("finished", "decode_steps",
                                        "prefill_tokens")}))
    assert runs[0] == runs[1] and runs[0][1]["finished"] == 4


@pytest.mark.cuda
def test_kernel_entries_refuse_inputs_that_need_grad(cuda):
    """The kernels have no backward: a CUDA entry given an input that
    requires grad under grad mode raises instead of cutting the gradient;
    under no_grad, or with inputs that need none, it launches."""
    x = torch.randn(4, 256, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.zeros(256, device=cuda, dtype=torch.bfloat16)
    for call in (lambda: ops.rmsnorm(x, w),
                 lambda: ops.add_rmsnorm(x.detach(), x, w),
                 lambda: ops.flash_attention(
                     x.view(1, 4, 2, 128), x.view(1, 4, 2, 128).detach(),
                     x.view(1, 4, 2, 128).detach(),
                     torch.arange(4, device=cuda, dtype=torch.int32)[None],
                     torch.arange(4, device=cuda, dtype=torch.int32)[None])):
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    assert ops.LAUNCHES["rmsnorm"] == 0
    with torch.no_grad():
        ops.rmsnorm(x, w)
    ops.rmsnorm(x.detach(), w)
    assert ops.LAUNCHES["rmsnorm"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2-moe-a2.7b",
                                  "mamba2-2.7b", "recurrentgemma-9b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-medium"])
def test_training_on_card_matches_cpu_and_launches_no_kernel(cuda, arch):
    """One loss and gradient of the reduced model in fp32 (TF32 off) on
    the card and on the CPU from the same params and batch: the loss
    within 1e-4, every gradient within 1e-3 x max|g|, and no kernel
    launched (training takes the plain forms)."""
    from repro_torch.config.base import TrainConfig
    from repro_torch.config.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.params import named_leaves
    from repro_torch.training.data import MarkovData
    from repro_torch.training.train_loop import (to_device, trainable,
                                                 value_and_grad)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_config(arch, "reduced")
        p_cpu = build_model(cfg, torch.float32, "cpu").init(0)
        batch = next(MarkovData(cfg, TrainConfig(
            global_batch=2, seq_len=40)).batches())
        out = []
        for dev in ("cpu", cuda):
            m = build_model(cfg, torch.float32, dev)
            p = trainable(_to(p_cpu, dev))
            loss, _, grads = value_and_grad(m, p, to_device(batch, dev))
            out.append((float(loss), {n: g.cpu() for n, g in
                                      named_leaves(grads)}))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    for n, g in g_cpu.items():
        assert (g_gpu[n] - g).abs().max() <= 1e-3 * g.abs().max() + 1e-6, n
    assert not any(ops.LAUNCHES.values()), ops.LAUNCHES


def _to(p, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in p.items()}


# tensor-parallel serving (DESIGN §12) on the card: one rank over NCCL with
# its all-reduces captured in the step graphs, and each rank's attention
# launch against the same heads of the whole launch


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
def test_one_rank_nccl_mesh_on_graphs_equals_no_mesh_on_card(cuda, arch,
                                                              paged,
                                                              tmp_path):
    """A (1, 1) mesh over NCCL runs the tensor-parallel path (the
    all-reduces, the vocab-parallel embedding and head; mamba2's split
    gated norm, the RG-LRU's gather of x) inside its CUDA graphs; a
    one-rank all-reduce and gather are the identity, and the split norm
    over a whole row is the rmsnorm kernel bit for bit, so it serves the
    no-mesh engine's tokens and counters, every step a replay."""
    from repro_torch.launch.mesh import close_serving_group, make_serving_group

    rng = np.random.RandomState(3)
    prompts = [list(map(int, rng.randint(0, 256, size=n)))
               for n in (5, 21, 9, 30, 13, 17)]
    base = _graph_engine(cuda, arch, paged, True)
    base.warmup()
    want_toks, want = _served(base, prompts)
    group = make_serving_group((1, 1), "nccl", 0, 1,
                               init_method=f"file://{tmp_path}/store")
    try:
        eng = _graph_engine(cuda, arch, paged, True, group=group)
        eng.warmup()
        toks, got = _served(eng, prompts)
    finally:
        close_serving_group()
    assert toks == want_toks
    assert {k: got[k] for k in GRAPH_COUNTERS} \
        == {k: want[k] for k in GRAPH_COUNTERS}
    assert eng.graphs.captures == len(eng.graphs.steps) > 0
    assert all(st.graph is not None for st in eng.graphs.steps.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_per_rank_attention_launches_match_the_whole_launch_on_card(cuda,
                                                                    dtype):
    """The TP-2 rank launches of `bench.tp_slices`: in fp32 every rank's
    decode, paged decode and prefill chunks on its kv-heads (granite's,
    the non-causal ones) are the whole launch's heads bit for bit; in
    bf16 where both launches split the key axis alike, within 2e-2 where
    the rank's smaller grid splits it more; mamba2's SSD term on 40 of 80
    heads and the gated RG-LRU on 2048 of 4096 channels bit for bit in
    both types; the hybrid's attention on its 8 of 16 query heads within
    tolerance."""
    from repro_torch.bench import tp_slices

    rows = [tp_slices.compare(c)
            for c in tp_slices.cases(cuda, getattr(torch, dtype))]
    assert all(tp_slices.verdict(r) for r in rows), rows
    if dtype == "float32":
        assert all(all(r["bitwise"]) for r in rows if r["exact"])
    else:
        same = [r["splits_whole"] == r["splits_rank"] for r in rows]
        assert any(same) and not all(same)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("H,KV,hd,S,parts,window", [
    (32, 8, 128, 512, 2, 0), (32, 8, 128, 96, 4, 64),
    (16, 1, 256, 256, 4, 0)])
def test_partial_decode_and_combine_match_plain_on_card(cuda, dtype, H, KV,
                                                        hd, S, parts,
                                                        window):
    """The sequence-sharded decode's kernels: each of `parts` contiguous
    slot ranges of ragged rows (one padding row, one whose last ranges
    hold no visible key) through `decode_attention_partial`, the partials
    through `attention_combine`: the partials within 2e-2 (bf16 inputs)
    or 1e-4 of max|plain| (fp32) of the plain versions, the combined
    output within the same of the plain whole decode (a padding row 0),
    one launch each."""
    rng = np.random.RandomState(S)
    B = 3
    q_pos = np.array([S - 1, S // 3, -1], np.int32)
    k_pos = np.where(np.arange(S)[None] <= np.array([[S], [S // 3], [S]]),
                     np.arange(S)[None], -1).astype(np.int32)
    dt = getattr(torch, dtype)
    q, k, v, qp, kp = _on(cuda, rng.randn(B, H, hd), rng.randn(B, S, KV, hd),
                          rng.randn(B, S, KV, hd), q_pos, k_pos, dtype=dt)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else None
    os_, mls = [], []
    for i in range(parts):
        sl = slice(i * S // parts, (i + 1) * S // parts)
        a = (q, k[:, sl].contiguous(), v[:, sl].contiguous(), qp,
             kp[:, sl].contiguous())
        o, ml = ops.decode_attention_partial(*a, window=window)
        wo, wml = ref.decode_attention_partial_ref(*a, window=window)
        for got, want in ((o, wo), (ml, wml)):
            torch.testing.assert_close(got, want, **(tol or dict(
                rtol=0, atol=1e-4 * float(want.abs().max()))))
        os_.append(o)
        mls.append(ml)
    out = ops.attention_combine(torch.stack(os_), torch.stack(mls), dtype=dt)
    want = ref.decode_attention_ref(q, k, v, qp, kp, window=window)
    assert out.dtype == dt
    torch.testing.assert_close(out.float(), want.float(), **(tol or dict(
        rtol=0, atol=1e-4 * float(want.abs().max()))))
    assert float(out[2].abs().max()) == 0.0
    assert ops.LAUNCHES["decode_attention_partial"] == parts
    assert ops.LAUNCHES["attention_combine"] == 1
