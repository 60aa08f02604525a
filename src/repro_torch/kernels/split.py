"""The key-axis split (flash-decoding) of the bf16 tensor-core attention
kernels (`csrc/attention_mma.cuh`), shared by the contiguous decode and the
prefill flash-attention wrappers.

A block of those kernels owns one (batch row, kv head) and up to 64 of its
Tq * G packed query rows, so a decode step or a short prefill chunk makes a
grid of B * KV * row_tiles blocks: 4 to 64 at the serving shapes, on a card
of 132 SMs. Where that grid is under half a wave, the key tiles are cut
into `n_splits` contiguous ranges, each taken by its own block, and a
combine pass merges their partial (m, l, O). `num_splits` picks the count;
`split_ranges` is the kernel's own cut, and `paged_slots` its walk of a
block table (paged decode and paged chunks), written out for the tests.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple

import torch


def key_tile(hd: int, rows: int) -> int:
    """Keys per K/V tile: 64; 32 at head_dim 256 when each warp takes whole
    tiles (rows > 16), for the register budget."""
    return 32 if hd >= 256 and rows > 16 else 64


def row_tiles(rows: int) -> int:
    """Blocks along the packed query rows (rows = Tq * G) of one (batch
    row, kv head): one when they fit a warp (16 rows; the block's 4 warps
    then split the keys), else 64 rows a block."""
    return 1 if rows <= 16 else -(-rows // 64)


def num_splits(B: int, KV: int, n_row_tiles: int, key_tiles: int,
               sm_count: int) -> int:
    """Key ranges per (batch row, kv head, row tile): enough for the grid
    to reach about half a wave (sm_count // 2 blocks of 4 warps), at most
    one range per key tile, and one when the grid is that large already.
    Measured on an H100 at the serving shapes, more splits than that lose
    more to the combine pass and to each block's fixed latency (k_pos, the
    first tile) than they gain in parallel loads."""
    blocks = B * KV * n_row_tiles
    return max(1, min(key_tiles, (sm_count // 2) // blocks))


def split_ranges(key_tiles: int, n_splits: int) -> List[Tuple[int, int]]:
    """Key tiles [begin, end) of each split, as the kernel cuts them."""
    return [(s * key_tiles // n_splits, (s + 1) * key_tiles // n_splits)
            for s in range(n_splits)]


def paged_slots(tables: torch.Tensor, block_size: int) -> torch.Tensor:
    """The kernel's block-table walk: logical slot s of row b (of
    MB * block_size) is physical slot tables[b, s // bs] * bs + s % bs of
    the pools, or -1 where the table entry is < 0 (the slot reads as empty
    and its K/V are never read). tables: (B, MB) -> (B, MB * bs) int64."""
    B, MB = tables.shape
    s = torch.arange(MB * block_size, device=tables.device)
    blk = tables.long()[:, s // block_size]
    return torch.where(blk >= 0, blk * block_size + s % block_size, -1)


@lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def plan(q: torch.Tensor, B: int, KV: int, rows: int, Tk: int, hd: int,
         out_rows: int, partial: bool = False
         ) -> Tuple[int, List[Optional[torch.Tensor]]]:
    """(n_splits, [part_o, part_ml]) for one call: `rows` = Tq * G packed
    rows per (batch row, kv head), `out_rows` = B * Tq * H. The fp32
    scratch of the combine pass exists only for a bf16 call with
    n_splits > 1, or any bf16 `partial` call (its splits always write
    partials for the unnormalized combine); else [None, None] (fp32 takes the
    CUDA-core kernel, which does not split). The caller keeps it alive
    across the launch."""
    if q.dtype != torch.bfloat16:
        return 1, [None, None]
    ns = num_splits(B, KV, row_tiles(rows), -(-Tk // key_tile(hd, rows)),
                    sm_count(q.device.index))
    if ns == 1 and not partial:
        return 1, [None, None]
    return ns, [torch.empty((ns, out_rows, hd), dtype=torch.float32,
                            device=q.device),
                torch.empty((ns, out_rows, 2), dtype=torch.float32,
                            device=q.device)]


def pointers(scratch: List[Optional[torch.Tensor]]) -> List[Optional[int]]:
    return [None if t is None else t.data_ptr() for t in scratch]
