"""The key-axis split (flash-decoding) of the bf16 tensor-core attention
kernels (`csrc/attention_mma.cuh`, `csrc/flash_wgmma.cuh`), shared by the
contiguous decode and the prefill flash-attention wrappers, and the route
that picks a prefill call's kernel.

A block of those kernels owns one (batch row, kv head) and up to 64 of its
Tq * G packed query rows, so a decode step or a short prefill chunk makes a
grid of B * KV * row_tiles blocks: 4 to 64 at the serving shapes, on a card
of 132 SMs. Where that grid is under half a wave, the key tiles are cut
into `n_splits` contiguous ranges, each taken by its own block, and a
combine pass merges their partial (m, l, O). `num_splits` picks the count;
`split_ranges` is the kernel's own cut, and `paged_slots` its walk of a
block table (paged decode and paged chunks), written out for the tests.

Prefill has two bf16 designs (`route`): the mma.sync kernel above, and
for calls of at least WGMMA_MIN_ROWS packed rows the long-row kernel
(`csrc/flash_wgmma.cuh`: 128 rows a block, a TMA ring, wgmma), whose
blocks own 128 rows and walk 64-key tiles.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple

import torch


#: prefill kernels, as the C entries' `kernel` argument takes them: the
#: dtype's own kernel (bf16: attention_mma.cuh's mma.sync kernel; fp32:
#: the CUDA-core kernel) and the long-row wgmma kernel
KERNEL_CODE = {"mma": 0, "fp32": 0, "wgmma": 1}
#: packed rows (Tq * G per batch row and kv head) from which a bf16
#: prefill call takes the wgmma kernel. Granite's 16-token chunk (64 rows)
#: stays on the mma.sync kernel.
WGMMA_MIN_ROWS = 128
WGMMA_HEAD_DIMS = (64, 128)
#: the wgmma kernel stages every k_pos of its key range in shared memory
WGMMA_MAX_KEYS = 2048
#: the wgmma kernel's packed rows a block and keys a tile
WGMMA_ROWS, WGMMA_KEYS = 128, 64


def wgmma_takes(dtype: torch.dtype, hd: int, Tk: int,
                block_size: Optional[int] = None) -> bool:
    """Whether the wgmma kernel can run a call at all (whatever its rows):
    bf16, head_dim 64 or 128, at most WGMMA_MAX_KEYS key slots; paged, a
    block size that is a multiple of 16 and divides, or is a multiple of,
    the kernel's key tile (a TMA box a block's rows; the kernel itself
    takes multiples of 8, but 8-row boxes ran slower than the mma.sync
    kernel on an H100)."""
    if dtype != torch.bfloat16 or hd not in WGMMA_HEAD_DIMS \
            or Tk > WGMMA_MAX_KEYS:
        return False
    bs = block_size
    return bs is None or (bs % 16 == 0 and (WGMMA_KEYS % bs == 0
                                            or bs % WGMMA_KEYS == 0))


def route(dtype: torch.dtype, hd: int, rows: int, Tk: int,
          block_size: Optional[int] = None) -> str:
    """The kernel a prefill call takes: "fp32" (the CUDA-core kernel) for
    fp32; "wgmma" for a bf16 call of at least WGMMA_MIN_ROWS packed rows
    (`rows` = Tq * G) that the wgmma kernel can run (`wgmma_takes`;
    `block_size` for a paged call); "mma" otherwise."""
    if dtype != torch.bfloat16:
        return "fp32"
    if rows >= WGMMA_MIN_ROWS and wgmma_takes(dtype, hd, Tk, block_size):
        return "wgmma"
    return "mma"


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


def launch_splits(kernel: str, B: int, KV: int, rows: int, Tk: int,
                  hd: int, sms: int) -> int:
    """The split count of a call on `kernel` ("mma" or "wgmma"), by
    `num_splits` over that kernel's blocks: 64 rows and `key_tile` keys
    (mma), WGMMA_ROWS and WGMMA_KEYS (wgmma)."""
    if kernel == "wgmma":
        return num_splits(B, KV, -(-rows // WGMMA_ROWS),
                          -(-Tk // WGMMA_KEYS), sms)
    return num_splits(B, KV, row_tiles(rows), -(-Tk // key_tile(hd, rows)),
                      sms)


def plan(q: torch.Tensor, B: int, KV: int, rows: int, Tk: int, hd: int,
         out_rows: int, partial: bool = False, kernel: str = "mma"
         ) -> Tuple[int, List[Optional[torch.Tensor]]]:
    """(n_splits, [part_o, part_ml]) for one call on `kernel`: `rows` =
    Tq * G packed rows per (batch row, kv head), `out_rows` = B * Tq * H.
    The fp32 scratch of the combine pass exists only for a bf16 call with
    n_splits > 1, or any bf16 `partial` call (its splits always write
    partials for the unnormalized combine); else [None, None] (fp32 takes the
    CUDA-core kernel, which does not split). The caller keeps it alive
    across the launch."""
    if q.dtype != torch.bfloat16:
        return 1, [None, None]
    ns = launch_splits(kernel, B, KV, rows, Tk, hd, sm_count(q.device.index))
    if ns == 1 and not partial:
        return 1, [None, None]
    return ns, [torch.empty((ns, out_rows, hd), dtype=torch.float32,
                            device=q.device),
                torch.empty((ns, out_rows, 2), dtype=torch.float32,
                            device=q.device)]


def pointers(scratch: List[Optional[torch.Tensor]]) -> List[Optional[int]]:
    return [None if t is None else t.data_ptr() for t in scratch]
