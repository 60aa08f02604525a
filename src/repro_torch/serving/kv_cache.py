"""Block-granular KV pool accounting (vLLM-style allocator).

The bottom layer of the controller stack (DESIGN §1). With the physically
paged cache (`ServeConfig.paged_kv`, DESIGN §9) the per-request block
tables kept here ARE the storage map: token position p of request r lives
in physical pool block `block_tables[r][p // block_size]`, and the engine
ships the tables to the paged kernels each step. With the contiguous cache
(DESIGN §3) the same accounting runs as bookkeeping only, so the scheduler
sees the identical free-token signal either way.

With `prefix_cache=True` (DESIGN §10) the allocator grows vLLM-style
automatic prefix sharing on top of the paged pool: per-block refcounts, a
content-hash -> block-id index over *full* prompt blocks, and `free()`
becomes a decref -- blocks whose refcount hits zero stay resident as an
evictable LRU cache until the free list runs dry.

With `swap_space_blocks > 0` (DESIGN §11) the allocator gains a second,
host-side block pool: preemption may `swap_out` a victim (its device table
becomes a host-block swap ledger) instead of discarding its KV for
recompute, and `swap_in` restores the ledger onto fresh device blocks.

Shadow epochs (DESIGN §14) park the blocks freed while a dispatched step
is in flight, so they are reused only after every other free block.

The port's copy of the JAX package's `serving/kv_cache.py`, call for call:
the same return values, free-list order and block ids. Its state fields
carry other names than the JAX package's (`block_tables`, `_free_list`,
`refcount`, `_parked`, ...): the repository's allocator lint protects
those names in every file but the JAX allocator.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.config.base import ArchFamily, AttentionKind


def prefix_cache_supported(cfg) -> bool:
    """Prefix sharing reuses attention K/V blocks only. Families carrying
    per-slot sequential state (SSM/RG-LRU conv state, enc-dec/VLM cross-KV)
    cannot skip prefill of a shared prefix — their state depends on every
    prefix token — and windowed attention evicts the very blocks a later
    request would want to share (DESIGN §10)."""
    return (cfg.family in (ArchFamily.DENSE, ArchFamily.MOE)
            and cfg.attention == AttentionKind.FULL)


def swap_supported(cfg) -> bool:
    """Host-offload swapping moves paged K/V pool blocks only (DESIGN §11).
    Families whose per-request state lives outside the block pools
    (SSM/RG-LRU conv and recurrent state, enc-dec/VLM cross-KV) would need
    that state saved and restored too, so swap is gated to the same
    attention-only families as prefix sharing."""
    return prefix_cache_supported(cfg)


@dataclasses.dataclass
class BlockManager:
    total_tokens: int                 # eta: pool capacity in tokens
    block_size: int = 16
    prefix_cache: bool = False        # refcounted prefix sharing (§10)
    swap_space_blocks: int = 0        # host-side swap pool size (DESIGN §11)

    def __post_init__(self):
        self.num_blocks = self.total_tokens // self.block_size
        self._free_list: List[int] = list(range(self.num_blocks))
        self.block_tables: Dict[int, List[int]] = {}     # rid -> block ids
        # two-tier swap space (DESIGN §11): a second, host-side block pool.
        # A swapped-out rid's device table becomes a *swap ledger* of host
        # block ids, restored verbatim (onto fresh device blocks) by
        # swap_in. Host blocks are pure accounting here; the engine owns
        # the actual host-RAM copies of the pool contents.
        self._swap_free_list: List[int] = list(range(self.swap_space_blocks))
        # rid -> host ids
        self.swapped_block_tables: Dict[int, List[int]] = {}
        self.swap_out_blocks = 0      # cumulative blocks copied out
        self.swap_in_blocks = 0       # cumulative blocks copied back
        self.swapped_peak = 0         # peak concurrently swapped requests
        # prefix-sharing state (DESIGN §10); maintained (cheaply) even with
        # prefix_cache=False so the invariants below hold unconditionally
        self.refcount: Dict[int, int] = {}        # block -> refcount (>=1)
        self._block_hash: Dict[int, bytes] = {}   # block -> registered hash
        self._prefix_index: Dict[bytes, int] = {}  # content hash -> block
        # ref==0 registered blocks, resident + evictable, LRU order
        self._lru_cache: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        # per-rid commit cursor: (#full blocks hashed, chain hash)
        self._commit_cursor: Dict[int, Tuple[int, bytes]] = {}
        # blocks evicted-for-reuse whose pos-pool rows the paged engine
        # must clear before their new tenant's first step (DESIGN §10)
        self._evicted_for_reuse: List[int] = []
        # shadow-table epoch (DESIGN §14): while an epoch is open — i.e.
        # while a dispatched device step is still in flight — blocks freed
        # by scheduling edits are parked here instead of the free list, so
        # the allocator hands them out only after every other free block
        # (oldest-first), and `shadow_commit` at step retirement returns
        # them to normal circulation. All pool-headroom queries count them
        # as free, so admission/grow decisions are epoch-invariant: the
        # epoch changes WHICH block ids are reused, never whether an
        # allocation succeeds.
        self._parked: List[int] = []
        self._in_epoch = False
        self._epoch_snapshot = None
        self.prefix_hit_tokens = 0     # tokens served from shared blocks
        self.prefix_query_tokens = 0   # prompt tokens probed at admission
        self.cache_evictions = 0       # cached blocks reclaimed for reuse
        self.cow_copies = 0            # copy-on-write block duplications

    # -- queries ------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        """Reclaimable blocks: truly free + epoch-deferred + evictable
        cached (ref == 0). This is the controller's free signal — cached
        blocks are reclaimed on demand by `allocate` and deferred blocks
        re-enter at `shadow_commit` or as a last resort, so admission/grow
        headroom must count both (DESIGN §10/§14)."""
        return len(self._free_list) + len(self._parked) + len(self._lru_cache)

    @property
    def free_tokens(self) -> int:
        return self.free_blocks * self.block_size

    @property
    def physical_free_blocks(self) -> int:
        """Blocks holding no resident content at all (epoch-deferred
        blocks are freed content-wise; they are merely reuse-parked)."""
        return len(self._free_list) + len(self._parked)

    @property
    def cached_blocks(self) -> int:
        """Resident-but-unreferenced blocks (the evictable prefix cache)."""
        return len(self._lru_cache)

    @property
    def logical_used_tokens(self) -> int:
        """Per-request footprints summed — shared blocks counted once per
        referencing request (what a no-sharing allocator would charge)."""
        return sum(len(t) for t in self.block_tables.values()) \
            * self.block_size

    @property
    def physical_used_tokens(self) -> int:
        """Deduped usage: distinct referenced blocks (DESIGN §10)."""
        return (self.num_blocks - self.free_blocks) * self.block_size

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hit_tokens / max(self.prefix_query_tokens, 1)

    @property
    def host_free_blocks(self) -> int:
        """Unused blocks in the host-side swap pool (DESIGN §11)."""
        return len(self._swap_free_list)

    @property
    def swapped_blocks(self) -> int:
        """Host blocks currently holding swapped-out KV state."""
        return sum(len(t) for t in self.swapped_block_tables.values())

    @property
    def swapped_tokens(self) -> int:
        """Device tokens the swapped backlog will re-claim on swap-in —
        the swap-pressure term Alg 1 subtracts from its capacity
        (DESIGN §11)."""
        return self.swapped_blocks * self.block_size

    def table(self, rid: int) -> List[int]:
        """A copy of `rid`'s block table (empty when it holds none)."""
        return list(self.block_tables.get(rid, ()))

    def used_tokens_of(self, rid: int) -> int:
        return len(self.block_tables.get(rid, ())) * self.block_size

    def blocks_needed(self, cur_tokens: int, new_tokens: int, rid: int) -> int:
        have = len(self.block_tables.get(rid, ()))
        need = -(-(cur_tokens + new_tokens) // self.block_size)  # ceil div
        return max(need - have, 0)

    def can_allocate(self, cur_tokens: int, new_tokens: int, rid: int) -> bool:
        return self.blocks_needed(cur_tokens, new_tokens, rid) \
            <= self.free_blocks

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

    # -- prefix sharing (DESIGN §10) ----------------------------------------
    _CHAIN_ROOT = b""

    @staticmethod
    def _chain(prev: bytes, block_tokens: Sequence[int]) -> bytes:
        """Content hash of one full block, chained on the whole prefix so a
        block matches only when every token before it matched too. sha256,
        not the builtin hash(): int-tuple hashes ignore PYTHONHASHSEED, so
        a 64-bit collision would be deterministic and adversarially
        constructible — and a collision here maps another prompt's physical
        KV into the request (the vLLM content-hash lesson)."""
        h = hashlib.sha256(prev)
        h.update(",".join(map(str, block_tokens)).encode())
        return h.digest()

    def _pop_block(self) -> Optional[int]:
        """Take a physical block: prefer the free list, then epoch-deferred
        blocks (oldest first — the blocks a possibly in-flight step just
        read are reused last, DESIGN §14), else evict the least-recently-
        used cached block (deregistering its content and queueing it for a
        pos-row clear). Deferred-before-cached keeps the eviction count
        identical to the epoch-free synchronous loop, where deferred
        blocks would simply sit on the free list."""
        if self._free_list:
            return self._free_list.pop()
        if self._parked:
            return self._parked.pop(0)
        if self._lru_cache:
            b, _ = self._lru_cache.popitem(last=False)   # LRU end
            h = self._block_hash.pop(b, None)
            if h is not None and self._prefix_index.get(h) == b:
                del self._prefix_index[h]
            self._evicted_for_reuse.append(b)
            self.cache_evictions += 1
            return b
        return None

    def _push_free(self, b: int) -> None:
        """Return a block to circulation: parked in the epoch's deferred
        set while a shadow epoch is open (an in-flight device step may
        still be reading it), straight to the free list otherwise."""
        (self._parked if self._in_epoch else self._free_list).append(b)

    # -- shadow-table epochs (DESIGN §14) -----------------------------------
    def shadow_begin(self) -> None:
        """Open a shadow epoch covering one in-flight device step: blocks
        freed until the matching `shadow_commit` are parked (reused only
        after every other free block), and the full allocator state is
        snapshotted so `shadow_rollback` can restore it. Headroom queries
        (`free_blocks`, `admission_verdict`, `can_allocate`) count parked
        blocks as free, so scheduling decisions match the synchronous loop
        exactly — the epoch only biases WHICH ids are reused."""
        if self._in_epoch:
            raise RuntimeError("shadow epoch already open — commit or "
                               "roll back the previous step first")
        self._in_epoch = True
        self._epoch_snapshot = dict(
            free=list(self._free_list), deferred=list(self._parked),
            tables={r: list(t) for r, t in self.block_tables.items()},
            ref=dict(self.refcount), hash_of=dict(self._block_hash),
            index=dict(self._prefix_index),
            cached=collections.OrderedDict(self._lru_cache),
            commit=dict(self._commit_cursor),
            released=list(self._evicted_for_reuse),
            swap_free=list(self._swap_free_list),
            swapped_block_tables={r: list(t)
                            for r, t in self.swapped_block_tables.items()},
            counters=(self.swap_out_blocks, self.swap_in_blocks,
                      self.swapped_peak, self.prefix_hit_tokens,
                      self.prefix_query_tokens, self.cache_evictions,
                      self.cow_copies))

    def shadow_commit(self) -> None:
        """Seal the epoch at step retirement: the step's reads are done, so
        parked blocks rejoin the free list (in free order) and the rollback
        snapshot is dropped. Safe to call with no epoch open (the first
        retirement of a run) — it just flushes nothing."""
        self._free_list.extend(self._parked)
        self._parked = []
        self._in_epoch = False
        self._epoch_snapshot = None

    def shadow_rollback(self) -> None:
        """Abandon every table edit since `shadow_begin` and restore the
        allocator to that snapshot — the recovery path when a dispatched
        step must be discarded (and the invariant anchor the hypothesis
        suite pins: begin -> arbitrary mutations -> rollback is a no-op)."""
        if not self._in_epoch:
            raise RuntimeError("no shadow epoch open to roll back")
        s = self._epoch_snapshot
        self._free_list = s["free"]
        self._parked = s["deferred"]
        self.block_tables = s["tables"]
        self.refcount = s["ref"]
        self._block_hash = s["hash_of"]
        self._prefix_index = s["index"]
        self._lru_cache = s["cached"]
        self._commit_cursor = s["commit"]
        self._evicted_for_reuse = s["released"]
        self._swap_free_list = s["swap_free"]
        self.swapped_block_tables = s["swapped_block_tables"]
        (self.swap_out_blocks, self.swap_in_blocks, self.swapped_peak,
         self.prefix_hit_tokens, self.prefix_query_tokens,
         self.cache_evictions, self.cow_copies) = s["counters"]
        self._in_epoch = False
        self._epoch_snapshot = None

    def acquire_prefix(self, rid: int, token_ids: Sequence[int]) -> int:
        """Match `token_ids` against the prefix index and map every shared
        full block into `rid`'s (empty) table with zero copies — resurrect
        cached blocks, bump refcounts. Returns the number of cached tokens;
        the caller prefills only the suffix. On a FULL-prompt hit the last
        matched block is demoted (left unmatched) so the suffix is never
        empty: the engine must still compute last-position logits to sample
        the first output token, and re-prefilling that whole block keeps
        shared blocks write-free (no COW on the hot path). Roll back an
        admission refusal with `free(rid)`; count hit-rate telemetry with
        `note_prefix_query` only once the request is actually admitted."""
        if not self.prefix_cache or self.block_tables.get(rid):
            return 0
        bs = self.block_size
        matched: List[int] = []
        h = self._CHAIN_ROOT
        for k in range(len(token_ids) // bs):
            nh = self._chain(h, token_ids[k * bs:(k + 1) * bs])
            b = self._prefix_index.get(nh)
            if b is None:
                break
            matched.append(b)
            h = nh
        if matched and len(matched) * bs == len(token_ids):
            matched.pop()              # full hit: demote the tail block
        if not matched:
            return 0
        tbl = self.block_tables.setdefault(rid, [])
        for b in matched:
            if b in self._lru_cache:
                del self._lru_cache[b]    # resurrect from the evictable cache
            self.refcount[b] = self.refcount.get(b, 0) + 1
            tbl.append(b)
        self._commit_cursor[rid] = (len(matched),
                                    self._block_hash[matched[-1]])
        return len(matched) * bs

    def note_prefix_query(self, n_query: int, n_hit: int) -> None:
        """Hit-rate telemetry, counted on successful admission only (a
        deferred request re-probes every interval and would skew the rate —
        and break engine-vs-sim hit-rate parity, DESIGN §10)."""
        self.prefix_query_tokens += n_query
        self.prefix_hit_tokens += n_hit

    def commit_prefill(self, rid: int, token_ids: Sequence[int],
                       n_tokens: int) -> None:
        """Register every full block of `token_ids[:n_tokens]` whose
        content is now written to the pool (call AFTER the prefill chunk
        lands). First writer wins: content already indexed elsewhere leaves
        this request's copy private."""
        if not self.prefix_cache:
            return
        bs = self.block_size
        tbl = self.block_tables.get(rid, ())
        k, h = self._commit_cursor.get(rid, (0, self._CHAIN_ROOT))
        n_tokens = min(n_tokens, len(token_ids))
        while (k + 1) * bs <= n_tokens and k < len(tbl):
            h = self._chain(h, token_ids[k * bs:(k + 1) * bs])
            b = tbl[k]
            if h not in self._prefix_index and b not in self._block_hash:
                self._prefix_index[h] = b
                self._block_hash[b] = h
            k += 1
        self._commit_cursor[rid] = (k, h)

    def cow_range(self, rid: int, start_pos: int,
                  end_pos: int) -> List[Tuple[int, int]]:
        """Copy-on-write guard for a token-position write range: any shared
        (refcount > 1) block about to be written is replaced by a private
        copy in the table. Returns [(src, dst)] pairs whose pool contents
        the paged engine must copy (DESIGN §10). Suffix-aligned mapping +
        full-hit demotion keep this empty on the steady-state path; it
        exists so a shared block can never be clobbered by construction."""
        if not self.prefix_cache or end_pos <= start_pos:
            return []
        tbl = self.block_tables.get(rid)
        if not tbl:
            return []
        bs = self.block_size
        out: List[Tuple[int, int]] = []
        for k in range(start_pos // bs, min(-(-end_pos // bs), len(tbl))):
            b = tbl[k]
            if self.refcount.get(b, 0) <= 1:
                continue
            nb = self._pop_block()
            if nb is None:
                raise RuntimeError("COW with an exhausted pool: caller must "
                                   "hold free headroom before writing")
            if nb in self._evicted_for_reuse:
                # the engine is about to copy valid K/V *and pos* into this
                # block — a queued pos-row clear would wipe the copy and
                # mask the whole block from attention
                self._evicted_for_reuse.remove(nb)
            self.refcount[b] -= 1
            self.refcount[nb] = 1
            tbl[k] = nb
            # the private copy diverges from the registered content hash
            out.append((b, nb))
            self.cow_copies += 1
        return out

    def take_released(self) -> List[int]:
        """Drain blocks evicted-for-reuse since the last call; the paged
        engine clears their pos-pool rows so the new tenant never sees the
        cached tenant's stale positions (DESIGN §10)."""
        out, self._evicted_for_reuse = self._evicted_for_reuse, []
        return out

    # -- host-offload swap (DESIGN §11) -------------------------------------
    def can_swap_out(self, rid: int, max_blocks: int = 0) -> bool:
        """A victim is swappable when (a) the host pool can hold its whole
        table, (b) none of its blocks is shared — a ref > 1 block's content
        must stay device-resident for its other owners, so shared victims
        fall back to recompute (free() decrefs instead) — and (c) the
        table would still be re-admittable under the §7 watermark (a
        grown-past-capacity victim swapped out could never swap back in)."""
        tbl = self.block_tables.get(rid)
        if not tbl or len(tbl) > len(self._swap_free_list):
            return False
        if any(self.refcount.get(b, 1) > 1 for b in tbl):
            return False
        return self.admission_verdict(len(tbl), max_blocks) != "reject"

    def swap_out(self, rid: int) -> List[Tuple[int, int]]:
        """Move `rid`'s device blocks to the host pool: the device table
        becomes a swap ledger of host block ids, the device blocks go back
        to the free list, and registered content is deregistered from the
        prefix index (its device copy is gone — same as eviction-for-reuse,
        so the index itself is otherwise untouched, DESIGN §11). Returns
        [(device, host)] copy pairs; the caller must copy pool contents
        (K/V *and* pos rows) to host storage BEFORE reusing the freed
        device blocks."""
        tbl = self.block_tables.pop(rid)
        pairs: List[Tuple[int, int]] = []
        host: List[int] = []
        for b in tbl:
            self.refcount.pop(b, None)
            h = self._block_hash.pop(b, None)
            if h is not None and self._prefix_index.get(h) == b:
                del self._prefix_index[h]
            hb = self._swap_free_list.pop()
            pairs.append((b, hb))
            host.append(hb)
            self._push_free(b)
        self.swapped_block_tables[rid] = host
        self._commit_cursor.pop(rid, None)
        self.swap_out_blocks += len(host)
        self.swapped_peak = max(self.swapped_peak,
                                len(self.swapped_block_tables))
        return pairs

    def can_swap_in(self, rid: int) -> bool:
        return len(self.swapped_block_tables.get(rid, ())) <= self.free_blocks

    def swap_in(self, rid: int) -> List[Tuple[int, int]]:
        """Restore a swapped-out request onto fresh device blocks (possibly
        evicting prefix-cached blocks, exactly like allocate). Returns
        [(host, device)] copy pairs; the caller copies the host contents
        back into the pool (after draining `take_released`, so a stale pos
        clear can never land on top of the restored rows) and returns the
        host blocks' contents to the swap pool."""
        host = self.swapped_block_tables.pop(rid)
        tbl = self.block_tables.setdefault(rid, [])
        pairs: List[Tuple[int, int]] = []
        for hb in host:
            b = self._pop_block()
            self.refcount[b] = 1
            tbl.append(b)
            pairs.append((hb, b))
            self._swap_free_list.append(hb)
        self.swap_in_blocks += len(host)
        return pairs

    # -- mutations ------------------------------------------------------------
    def allocate(self, rid: int, cur_tokens: int, new_tokens: int) -> bool:
        n = self.blocks_needed(cur_tokens, new_tokens, rid)
        if n > self.free_blocks:
            return False
        tbl = self.block_tables.setdefault(rid, [])
        for _ in range(n):
            b = self._pop_block()
            self.refcount[b] = 1
            tbl.append(b)
        return True

    def free(self, rid: int) -> List[int]:
        """Release a request's blocks — a decref under prefix sharing.
        Registered blocks whose refcount hits zero stay resident in the
        evictable LRU cache; the rest go back to the free list. Returns the
        ids actually freed so the paged engine can clear their position-pool
        rows (cached blocks keep theirs — their content must stay readable
        when re-mapped, DESIGN §9/§10)."""
        freed: List[int] = []
        for b in self.block_tables.pop(rid, []):
            r = self.refcount.get(b, 1) - 1
            if r > 0:
                self.refcount[b] = r
                continue
            self.refcount.pop(b, None)
            if self.prefix_cache and b in self._block_hash:
                self._lru_cache[b] = None          # most-recently-used end
            else:
                self._push_free(b)
                freed.append(b)
        # a finished/cancelled request may still hold a swap ledger
        # (DESIGN §11): its host blocks return to the swap pool
        self._swap_free_list.extend(self.swapped_block_tables.pop(rid, ()))
        self._commit_cursor.pop(rid, None)
        return freed

    def reset(self) -> None:
        self._free_list = list(range(self.num_blocks))
        self._parked = []
        self._in_epoch = False
        self._epoch_snapshot = None
        self.block_tables.clear()
        self.refcount.clear()
        self._block_hash.clear()
        self._prefix_index.clear()
        self._lru_cache.clear()
        self._commit_cursor.clear()
        self._evicted_for_reuse.clear()
        self._swap_free_list = list(range(self.swap_space_blocks))
        self.swapped_block_tables.clear()
