"""The key-axis split of the bf16 attention kernels (`repro_torch.kernels.
split`): the split count and the key ranges the kernel cuts, as properties
over grid sizes and card sizes. CPU only; the kernels themselves are held
against their plain versions on the card by tests/test_torch_cuda.py."""
from _hypothesis_compat import given, settings, strategies as st

from repro_torch.kernels import split

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
