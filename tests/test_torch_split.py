"""The key-axis split of the bf16 attention kernels (`repro_torch.kernels.
split`): the split count and the key ranges the kernel cuts, as properties
over grid sizes and card sizes; and the route that gives each prefill
call one of its kernels. CPU only; the kernels themselves are held
against their plain versions on the card by tests/test_torch_cuda.py."""
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro_torch.kernels import split
from repro_torch.kernels.flash_attention import HEAD_DIMS

GRIDS = st.tuples(st.integers(1, 64), st.integers(1, 16), st.integers(1, 40),
                  st.integers(1, 600), st.sampled_from([1, 8, 66, 114, 132]))


@settings(max_examples=300, deadline=None)
@given(GRIDS)
def test_splits_cover_every_key_tile_once_and_none_is_empty(grid):
    B, KV, row_tiles, key_tiles, sms = grid
    ns = split.num_splits(B, KV, row_tiles, key_tiles, sms)
    assert 1 <= ns <= key_tiles
    ranges = split.split_ranges(key_tiles, ns)
    assert len(ranges) == ns
    assert all(lo < hi for lo, hi in ranges)
    covered = [t for lo, hi in ranges for t in range(lo, hi)]
    assert covered == list(range(key_tiles))


@settings(max_examples=300, deadline=None)
@given(GRIDS)
def test_no_split_once_the_grid_fills_the_card(grid):
    B, KV, row_tiles, key_tiles, sms = grid
    ns = split.num_splits(B, KV, row_tiles, key_tiles, sms)
    blocks = B * KV * row_tiles
    if blocks >= 2 * sms:
        assert ns == 1
    # about half a wave, unless the key tiles run out first
    assert blocks * ns <= max(blocks, sms // 2)
    assert ns == key_tiles or blocks * (ns + 1) > sms // 2


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 4096))
def test_row_tiles_hold_every_packed_row(rows):
    n = split.row_tiles(rows)
    per_block = 16 if rows <= 16 else 64
    assert (n - 1) * per_block < rows <= n * per_block


def test_serving_shapes():
    """On 132 SMs: granite decode (B 8, 8 kv heads, G 4: 64 blocks) and a
    500-token chunk (32 row tiles per kv head) do not split; granite at
    B 1 splits 16 key tiles 8 ways, recurrentgemma (G 16 on one kv head)
    at B 8 too."""
    assert split.key_tile(128, 4) == 64 and split.key_tile(256, 16) == 64
    assert split.key_tile(256, 64) == 32
    assert split.num_splits(8, 8, split.row_tiles(4), 16, 132) == 1
    assert split.num_splits(1, 8, split.row_tiles(2000), 16, 132) == 1
    assert split.num_splits(1, 8, split.row_tiles(4), 16, 132) == 8
    assert split.num_splits(8, 1, split.row_tiles(16), 16, 132) == 8


# ---------------------------------------------------------------------------
# the prefill route: which of the two bf16 designs (or the fp32 kernel)
# takes a call

BF, F32 = torch.bfloat16, torch.float32


def test_route_at_the_serving_shapes():
    """The long-row calls take the wgmma kernel: seamless's encoder (Tq =
    Tk = 1024, hd 64, G 1) whole and as a TP-2 rank (the same rows a kv
    head), granite's 500-token chunk (G 4: 2000 rows, hd 128) contiguous
    and paged, starcoder2's 16-token chunk (G 9: 144 rows), the VLM's
    16-token cross chunk (G 8: 128 rows over 1601 patches). Granite's
    16-token chunk (64 rows), the Tq-1 cross decodes, hd 32 and 256, fp32,
    the paged cross read in blocks of 1601 and rows past the staged key
    slots do not."""
    r = split.route
    assert r(BF, 64, 1024, 1024) == "wgmma"              # encoder, its rank
    assert r(BF, 128, 500 * 4, 1024) == "wgmma"          # granite Tq 500
    assert r(BF, 128, 500 * 4, 64 * 16, 16) == "wgmma"   # ... paged
    assert r(BF, 128, 16 * 9, 1024, 16) == "wgmma"       # starcoder2 Tq 16
    assert r(BF, 128, 16 * 8, 1601) == "wgmma"           # VLM cross chunk
    assert r(BF, 128, 16 * 4, 1024) == "mma"             # granite Tq 16
    assert r(BF, 128, 16 * 4, 64 * 16, 16) == "mma"      # ... paged
    assert r(BF, 64, 1, 1024) == "mma"                   # cross decode
    assert r(BF, 128, 8, 1601) == "mma"                  # VLM cross decode
    assert r(BF, 128, 16 * 8, 1601, 1601) == "mma"       # paged cross, bs 1601
    assert r(BF, 64, 1024, 1024, 8) == "mma"             # 8-row boxes
    assert r(BF, 256, 500 * 16, 1024) == "mma"           # recurrentgemma
    assert r(BF, 32, 1024, 1024) == "mma"                # hd 32
    assert r(F32, 64, 1024, 1024) == "fp32"
    assert r(BF, 64, 1024, split.WGMMA_MAX_KEYS + 1) == "mma"


def test_wgmma_splits_follow_its_own_blocks():
    """The encoder's grid (8 row tiles of 128 on 16 kv heads) and granite's
    Tq-500 chunk (16 on 8) fill the card: no split; a TP-2 rank (half the
    kv heads) neither; the VLM's Tq-16 cross chunk (1 row tile on 8 kv
    heads) splits its 26 key tiles of 64 to half a wave."""
    ls = split.launch_splits
    assert ls("wgmma", 1, 16, 1024, 1024, 64, 132) == 1
    assert ls("wgmma", 1, 8, 1024, 1024, 64, 132) == 1
    assert ls("wgmma", 1, 8, 2000, 1024, 128, 132) == 1
    assert ls("wgmma", 1, 4, 2000, 1024, 128, 132) == 1
    assert ls("wgmma", 1, 8, 128, 1601, 128, 132) == 8
    assert ls("mma", 1, 8, 64, 1024, 128, 132) \
        == split.num_splits(1, 8, 1, 16, 132)


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 600), st.sampled_from([1, 2, 4, 8, 9, 16]),
       st.sampled_from(HEAD_DIMS), st.sampled_from([BF, F32]),
       st.sampled_from([None, 1, 8, 16, 64, 128, 1024, 1601]),
       st.integers(1, 5000))
def test_every_call_maps_to_one_kernel_that_takes_it(Tq, G, hd, dtype, bs,
                                                     Tk):
    """Every (Tq, G, hd, dtype, block size) at the prefill entries' head
    dims takes exactly one kernel, and that kernel takes the call: fp32 the
    CUDA-core kernel, bf16 the mma.sync kernel (every head dim) or, at
    WGMMA_MIN_ROWS packed rows or more, the wgmma kernel where it can run
    the call (hd 64 or 128, the key slots it stages, a block size it
    boxes)."""
    rows = Tq * G
    Tk = Tk if bs is None else -(-Tk // bs) * bs
    kernel = split.route(dtype, hd, rows, Tk, bs)
    takes = {"fp32": dtype == F32, "mma": dtype == BF,
             "wgmma": rows >= split.WGMMA_MIN_ROWS
             and split.wgmma_takes(dtype, hd, Tk, bs)}
    assert takes[kernel]
    assert kernel in split.KERNEL_CODE
    if dtype == F32:
        assert kernel == "fp32"
    else:
        assert (kernel == "wgmma") == takes["wgmma"]
