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
# RMSNorm in CUDA C++, with and without the fused residual add


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2560, 4096, 5120])
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

GRAPH_FAMILIES = ("granite-3-8b", "mamba2-2.7b", "recurrentgemma-9b")
GRAPH_COUNTERS = ("decode_steps", "mean_batch", "admitted", "preemptions",
                  "prefill_tokens", "finished", "copy_rows")


def _graph_engine(dev, arch, paged, cuda_graphs):
    """Reduced fp32 engine on the card: static admission (batches of up to
    4, so decode moves between buckets) and chunked prefill on 2 lanes."""
    from repro_torch.config.base import ServeConfig
    from repro_torch.config.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine

    m = build_model(get_config(arch, "reduced"), torch.float32, dev)
    serve = ServeConfig(policy="static", b_max=4, max_new_tokens=6,
                        kv_pool_tokens=1024, block_size=8,
                        chunked_prefill=True, chunk_budget_tokens=16,
                        n_prefill_lanes=2, paged_kv=paged)
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
