"""Block-granular KV pool accounting (vLLM-style allocator).

The bottom layer of the controller stack (DESIGN §1). With the physically
paged cache (`ServeConfig.paged_kv`, DESIGN §9) the per-request block
tables kept here ARE the storage map: token position p of request r lives
in physical pool block `block_tables[r][p // block_size]`. With the
contiguous cache (DESIGN §3) the same accounting runs as bookkeeping only,
so the scheduler sees the identical free-token signal either way.

The port's copy of the JAX package's `serving/kv_cache.py`, cut to what
the port's engine runs: allocation, free and the admission gate. Prefix
sharing (DESIGN §10), the swap pool (DESIGN §11) and shadow epochs
(DESIGN §14) come with the slices that port those features. The state
fields carry other names than the JAX package's (`block_tables`,
`_free_list`): the repository's allocator lint protects those names in
every file but the JAX allocator.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class BlockManager:
    total_tokens: int                 # eta: pool capacity in tokens
    block_size: int = 16

    def __post_init__(self):
        self.num_blocks = self.total_tokens // self.block_size
        self._free_list: List[int] = list(range(self.num_blocks))
        self.block_tables: Dict[int, List[int]] = {}     # rid -> block ids

    # -- queries ------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free_list)

    @property
    def free_tokens(self) -> int:
        return self.free_blocks * self.block_size

    @property
    def logical_used_tokens(self) -> int:
        """Per-request footprints summed."""
        return sum(len(t) for t in self.block_tables.values()) \
            * self.block_size

    @property
    def physical_used_tokens(self) -> int:
        """Distinct referenced blocks (equal to the logical count without
        prefix sharing)."""
        return (self.num_blocks - self.free_blocks) * self.block_size

    def table(self, rid: int) -> List[int]:
        """A copy of `rid`'s block table (empty when it holds none)."""
        return list(self.block_tables.get(rid, ()))

    def blocks_needed(self, cur_tokens: int, new_tokens: int, rid: int) -> int:
        have = len(self.block_tables.get(rid, ()))
        need = -(-(cur_tokens + new_tokens) // self.block_size)  # ceil div
        return max(need - have, 0)

    def admission_verdict(self, blocks_needed: int,
                          max_blocks: int = 0) -> str:
        """Shared engine/sim admission gate (DESIGN §7): the vLLM-style 1%
        free-block watermark plus the unservable-request bound.

        Returns "admit" (enough pool headroom), "defer" (watermark refusal
        that a future pool state can satisfy), or "reject" (no pool state
        can ever satisfy it — larger than the pool minus the watermark, or
        than `max_blocks`, the per-request block-table width, if given)."""
        watermark = max(self.num_blocks // 100, 1)
        if self.free_blocks - blocks_needed >= watermark:
            if max_blocks and blocks_needed > max_blocks:
                return "reject"
            return "admit"
        cap = self.num_blocks - watermark
        if max_blocks:
            cap = min(cap, max_blocks)
        return "reject" if blocks_needed > cap else "defer"

    # -- mutations ------------------------------------------------------------
    def allocate(self, rid: int, cur_tokens: int, new_tokens: int) -> bool:
        n = self.blocks_needed(cur_tokens, new_tokens, rid)
        if n > self.free_blocks:
            return False
        tbl = self.block_tables.setdefault(rid, [])
        for _ in range(n):
            tbl.append(self._free_list.pop())
        return True

    def free(self, rid: int) -> List[int]:
        """Release a request's blocks; returns their ids so the paged engine
        can clear their position-pool rows (DESIGN §9)."""
        freed = self.block_tables.pop(rid, [])
        self._free_list.extend(freed)
        return freed
