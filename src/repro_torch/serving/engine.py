"""Continuous-batching serving engine over the port's PyTorch model.

Runs the same controller stack as the JAX package's engine (Telemetry ->
Policy -> BlockManager, DESIGN §1). Decode runs on the smallest batch
bucket >= the active requests (DESIGN §3), padding rows masked by
position -1.

PD fusion (DESIGN §6) runs `n_prefill_lanes` spare physical cache rows
past the decode buckets; each interval the controller's chunk budget is
packed across occupied lanes and same-size lane chunks run as one
multi-row prefill. Finished lanes promote into the compacted decode region.
The paged cache (DESIGN §9) keeps K/V in block pools addressed through the
BlockManager's tables, so promotion, finish and eviction copy nothing.

On the paged pool of the attention-only families (no per-request state,
no cross K/V: `mixed`), an interval that decodes runs its decode rows and
the chunks of every lane that does not finish its prompt as one forward,
the mixed step (`layers.MixedRows`): one pass over the weights. A chunk
takes a row of `prefill_chunk` tokens, its unused tail at position -1; an
idle lane takes no row, since each row's attention walks its whole block
table. A finishing lane's chunk runs first, as a chunk step of its own, so
that the request it promotes decodes in the same interval from its first
token, as in the reference. An interval without decode rows runs chunk
steps only. The stateful families keep exact-size chunks with no pad
tokens (`pack_chunks`), a first chunk with extras runs as its own step,
and the contiguous layout keeps its lane rows: those run a chunk step a
chunk size, then the decode step.

Per-request state (DESIGN §9; SSM conv/ssm, RG-LRU conv/rec) is a cache row
per slot. In the contiguous layout it moves with the K/V row. In the paged
layout a request pins a state slot from `_free_slots` for its whole life;
decode reads the slots of the active requests and pads the bucket with the
sentinel slot, which reads zeros and is never written. State-only families
(no K/V: `mem.bytes_per_token == 0`) hold one block per request as an
admission cap, never grow it, and never preempt.

Every decode step, mixed step and prefill chunk is a `graphs.Step` per
shape key, the counterpart of the reference's `jax.jit` per shape: on the
card the replay of a CUDA graph captured once (`warmup()` captures every
decode bucket, its mixed steps and every full-chunk lane shape; tail chunks
capture at first use), on the CPU the
same function run eagerly. Step inputs are staged in pinned host memory and
copied without blocking.

Async dispatch-ahead (DESIGN §14): `step()` schedules and dispatches
interval N, then retires the oldest intervals until at most
`overlap_depth` remain in flight; depth 0 retires N in the same call. An
interval's tokens stay on the device: a decode step of a later interval
splices them in from `_pending_tok`. At dispatch the interval's sampled
and first tokens are concatenated on the device and copied, without
blocking, into pinned memory of the interval's own staging arena, and on
the card a CUDA event is recorded behind that copy. Retirement waits on
that event alone (the interval's one synchronisation: its wait is the
device time the host could not hide and a decode step's TBT sample, as in
the reference), reads the pinned tokens, applies the interval's telemetry
feeds and timestamps, rewinds its arena and seals the allocator's shadow
epoch. The staging ring holds `overlap_depth + 1` arenas, so no pinned
byte that a queued copy has yet to read is overwritten (`graphs.Staging`).
On the CPU the same path runs eagerly: every copy has completed when it
returns.

The memory tiers run on the paged pool of the attention-only families, as
in the reference (DESIGN §10, §11). Prefix sharing maps a prompt's indexed
full blocks into its table at admission, prefills only the suffix and
registers each chunk's full blocks once its K/V is dispatched; a shared
block about to be written is first copied in place (copy-on-write on the
pools, whose addresses the CUDA graphs captured). The swap tier moves a
preemption victim's K, V and position rows into a block-major host pool
(pinned on the card) and back on swap-in, with non-blocking copies on the
engine's one stream, which orders them after the steps that wrote those
rows and before any later reuse: the swap path adds no synchronisation.

Tensor-parallel serving (DESIGN §12, `ServeConfig.mesh_shape`; the dense,
MoE, VLM and enc-dec families) runs one engine per rank process on a
model built on the rank's serving group
(`launch.mesh.make_serving_group`). Every rank runs this host code, so
every decision must come out the same on each:
the inputs they schedule from are the same, and the measured values that
feed decisions (the clock, each retirement's wait, the interval's host
time) are rank 0's, agreed once an interval by one broadcast on the
group's gloo control group (`_agree`), never in a step. After an idle
stretch (the engine's build, a drain) the first stamp agrees rank 0's
clock afresh (`_fresh_clock`), so a stamp is never older than one
interval's host time, idle time included. The pool holds the global
block count (the per-chip budget times `model_shards`) at the rank's
kv-heads; block tables, and so prefix sharing, are the same on every
rank, and the swap tier moves each rank's own kv-head slice.

The VLM and enc-dec families take per-request extras (image patch or
audio frame embeddings, `submit(..., extras=)`), cast to the working dtype
and kept for the request's life: a recompute preemption prefills again
from position 0. As in the reference, a first chunk that carries extras
runs as a single-row step of its own shape key ("xchunk"), whose static
(1, enc_len, d) input the extras are staged into; it alone writes the
request's cross-attention K/V row, which every later step reads.

Tracing (`trace.py`, docs/PORT.md "Tracing the engine"): while a profiler
collects, a busy `step()` runs inside named profiler ranges and times each
interval's stream with CUDA events; every busy `step()` appends an
`Interval` to `self.trace`, index-aligned with `step_host_trace`, with the
step replays it dispatched (`Interval.replays`).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, ServeConfig
from repro_torch.core.batching import bucketize, make_policy
from repro_torch.core.lanes import lane_order, pack_chunks
from repro_torch.core.memory_model import MemoryModel, kv_shard_factor
from repro_torch.core.telemetry import Telemetry
from repro_torch.distributed.sharding import check_tp
from repro_torch.models.backbone import (CROSS_KEYS, STATE_KEYS, extras_key,
                                         init_cache, init_paged_cache)
from repro_torch.models.layers import MixedRows
from repro_torch.models.model import Model, resolve_device
from repro_torch.serving.cost_model import PROFILES, CostModel
from repro_torch.serving.graphs import Staging, Step, StepGraphs
from repro_torch.serving.kv_cache import (BlockManager, prefix_cache_supported,
                                          swap_supported)
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.sampling import sample
from repro_torch.serving.trace import STEP_SPANS, EngineTrace, Interval, span


def cache_rows(cache: Dict[str, torch.Tensor],
               rows) -> Dict[str, torch.Tensor]:
    """Rows `rows` (an int, a slice or an index tensor) of a contiguous
    cache: `pos` has its rows on axis 0, every other key on axis 1. An int
    or a slice gives views."""
    return {k: v[rows] if k == "pos" else v[:, rows] for k, v in cache.items()}


def put_cache_rows(cache: Dict[str, torch.Tensor], rows,
                   sub: Dict[str, torch.Tensor]) -> None:
    """Write the keys of `sub` into rows `rows` of a contiguous cache, in
    place."""
    for k, v in sub.items():
        if k == "pos":
            cache[k][rows] = v
        else:
            cache[k][:, rows] = v


#: the paged pools a swap or a copy-on-write moves, block axis 0 for `pos`
#: and 1 for K and V
POOL_KEYS = ("k", "v", "pos")


def check_ported(serve: ServeConfig, cfg: ModelConfig) -> None:
    """Raise for what the port does not serve yet: a mesh for a family or
    a kv-head count that has no tensor-parallel port
    (`sharding.check_tp`)."""
    if serve.mesh_shape:
        check_tp(cfg, serve.model_axis_size)


def host_runs(ids: List[int]):
    """(start, stop, first id) of each run of consecutive ids in `ids`
    (sorted): one host copy each."""
    runs, a = [], 0
    for i in range(1, len(ids) + 1):
        if i == len(ids) or ids[i] != ids[i - 1] + 1:
            runs.append((a, i, ids[a]))
            a = i
    return runs


@dataclasses.dataclass
class _StepRec:
    """One interval's retirement record: the device values to read back,
    the output-token placeholders they patch, and the telemetry feeds that
    land once the step's results exist (DESIGN §14)."""
    dec: Optional[torch.Tensor] = None            # sampled decode tokens
    first: List[torch.Tensor] = dataclasses.field(default_factory=list)
    probe: Optional[torch.Tensor] = None          # last prefill's tokens
    #: (request, output index, life generation, "d"|"f", value row)
    patches: List[Tuple[Request, int, int, str, int]] = \
        dataclasses.field(default_factory=list)
    #: (request, feed on_first_token, queue_s, prefill_start) TTFT stamps
    firsts: List[Tuple[Request, bool, float, float]] = \
        dataclasses.field(default_factory=list)
    #: (request, output length) completion stamps, finish order preserved
    completions: List[Tuple[Request, int]] = \
        dataclasses.field(default_factory=list)
    lane_tokens: Optional[Dict[int, int]] = None
    #: (request, chunk start, take) of the chunks the decode step runs
    #: with its rows, as one mixed step, a chunk row each
    lanes: List[Tuple[Request, int, int]] = \
        dataclasses.field(default_factory=list)
    n_decode: int = 0
    prefill_tokens: int = 0
    dispatched: bool = False
    #: set at dispatch: the tokens' pinned host copy, its staging arena,
    #: and (on the card) the event recorded behind the copy
    host: Optional[torch.Tensor] = None
    arena: int = -1
    event: Optional[torch.cuda.Event] = None
    #: the interval's trace record, and (spans on, on the card) the timing
    #: event recorded before its first work
    interval: Optional[Interval] = None
    start: Optional[torch.cuda.Event] = None


class Engine:
    def __init__(self, model: Model, params, serve: ServeConfig,
                 max_context: int = 256,
                 buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64),
                 prefill_chunk: int = 32, enc_len: int = 0, seed: int = 0,
                 temperature: float = 0.0, device=None,
                 cuda_graphs: Optional[bool] = None,
                 cost: Optional[CostModel] = None):
        """`enc_len`: cross keys a request (VLM, enc-dec; 0 for the
        family's default). `cuda_graphs`: run each step as a CUDA graph
        replay (default on the card); False runs the same steps eagerly, as
        on the CPU, where True raises. `cost`: the swap-vs-recompute
        crossover's cost model (DESIGN §11), the a100x8 profile by default,
        as in the reference. Under `serve.mesh_shape` the model must be
        built on a serving group of that shape; a gloo group's collectives
        cannot be captured, so on the card it runs with
        `cuda_graphs=False` only."""
        check_ported(serve, model.cfg)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.group = model.group
        have = self.group.mesh_shape if self.group is not None else ()
        if tuple(serve.mesh_shape) != have:
            raise ValueError(
                f"ServeConfig.mesh_shape {tuple(serve.mesh_shape)} needs a "
                f"model built on a serving group of that shape "
                f"(launch.mesh.make_serving_group); the model's is {have}")
        use_graphs = self.device.type == "cuda" if cuda_graphs is None \
            else cuda_graphs
        if use_graphs and self.group is not None \
                and self.group.backend != "nccl":
            raise ValueError(f"{self.group.backend} collectives cannot be "
                             f"captured in a CUDA graph: pass "
                             f"cuda_graphs=False")
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.serve = serve
        self.max_context = max_context
        self.buckets = tuple(sorted(b for b in buckets if b <= serve.b_max)) \
            or (serve.b_max,)
        self.max_slots = max(self.buckets)
        self.prefill_chunk = prefill_chunk
        self.params = params
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        # n_prefill_lanes spare physical rows past the decode buckets: a
        # padded decode step never touches a prefilling row (DESIGN §6)
        self.n_lanes = max(1, serve.n_prefill_lanes)
        # mesh serving (DESIGN §12): the pool shards on kv-heads, so a
        # per-chip budget backs model_shards x the tokens; only an explicit
        # budget scales (the slot-derived one is already all the block
        # tables can address), as in the reference
        self.model_shards = kv_shard_factor(
            self.cfg, self.group.model_size) if self.group is not None else 1
        eta = serve.kv_pool_tokens or self.max_slots * max_context
        self.mem = MemoryModel(self.cfg, hbm_budget_bytes=0,
                               eps_m=serve.eps_m,
                               block_size=serve.block_size, eta_tokens=eta,
                               model_shards=self.model_shards
                               if serve.kv_pool_tokens else 1)
        self.paged = serve.paged_kv
        # prefix sharing (DESIGN §10) and the host swap tier (DESIGN §11):
        # the paged pool of a family whose per-request state is all in the
        # K/V blocks, exactly the reference's gates
        kv_only = self.paged and self.mem.bytes_per_token != 0
        self.prefix = serve.prefix_cache and kv_only \
            and prefix_cache_supported(self.cfg)
        self.swap = serve.swap_space_blocks > 0 and kv_only \
            and serve.preempt != "recompute" and swap_supported(self.cfg)
        self.blocks = BlockManager(
            self.mem.eta, serve.block_size, prefix_cache=self.prefix,
            swap_space_blocks=serve.swap_space_blocks if self.swap else 0)
        self.cost = cost or CostModel(self.cfg, PROFILES["a100x8"])
        self.n_slots = self.max_slots + self.n_lanes
        # per-request block-table width: enough blocks for a full context
        self.max_blocks = -(-max_context // serve.block_size)
        # state-only family: constant per-request state, no K/V to grow
        self.state_only = self.mem.bytes_per_token == 0
        if self.paged:
            self.cache = model.init_paged_cache(
                self.mem.num_blocks, serve.block_size, n_slots=self.n_slots,
                enc_len=enc_len)
            self._free_slots = list(range(self.n_slots))
        else:
            self.cache = model.init_cache(self.n_slots, max_context,
                                          enc_len=enc_len,
                                          prefill_chunk=prefill_chunk)
        # the mixed step: lane chunks padded beside the decode rows in one
        # forward, where a pad token reaches no request's state (the paged
        # pools of a family without per-request state or cross K/V)
        self.mixed = self.paged and serve.chunked_prefill and not any(
            k in self.cache for k in STATE_KEYS + CROSS_KEYS)
        # a request's extras: (1, enc_len, d) in the working dtype
        self.enc_len = self.cache["cross_k"].shape[2] \
            if "cross_k" in self.cache else 0
        self._extras_shape = (1, self.enc_len, self.cfg.d_model)
        extras_bytes = self.enc_len * self.cfg.d_model \
            * torch.empty((), dtype=model.dtype).element_size()
        self.tel = Telemetry()
        self.policy = make_policy(serve, self.mem)
        self.graphs = StepGraphs(self.device, use_graphs)
        # async dispatch-ahead (DESIGN §14): up to overlap_depth dispatched
        # intervals stay un-retired while the host schedules the next
        self.overlap_depth = max(0, int(serve.overlap_depth))
        self._inflight: "collections.deque[_StepRec]" = collections.deque()
        # each arena holds a lane's extras per lane without growing
        self._staging = Staging(self.device,
                                nbytes=(1 << 16) + self.n_lanes * extras_bytes,
                                depth=self.overlap_depth)

        self.waiting: List[Request] = []
        self.active: List[Request] = []          # compact: slot i = active[i]
        # PD fusion (DESIGN §6): admitted requests being chunk-prefilled; a
        # request with r.lane >= 0 owns lane r.lane, the rest queue
        self.prefilling: List[Request] = []
        self.lanes: List[Optional[Request]] = [None] * self.n_lanes
        # offloaded requests awaiting swap-in, drained before `waiting`
        self.swapped: List[Request] = []
        self.now0 = time.perf_counter()
        # under a mesh: the clock rank 0 read at the last agreement, and
        # its retirement waits, ahead of `_retire_step` (`_agree`); the
        # clock is stale from the build and from each drain until the next
        # stamp agrees it afresh (`_fresh_clock`)
        self._agreed_now = 0.0
        self._clock_stale = True
        self._agreed_waits: "collections.deque[float]" = collections.deque()
        self._next_rid = 0
        self.total_decoded = 0
        self.total_finished = 0
        self.admitted_total = 0   # successful admissions from `waiting`
        self.preemptions = 0      # evictions, recompute + swap-out alike
        self.oom_events = 0       # admission refusals at the watermark
        self.rejected = 0         # requests too large for the pool, dropped
        # per-request goodput SLOs (DESIGN §15), stamped at retirement
        self.sla_requests_met = 0
        self.goodput_tokens = 0
        self.swap_outs = 0        # victims offloaded to the host pool
        self.swap_ins = 0         # offloaded requests restored
        self.swap_out_bytes = 0
        self.swap_in_bytes = 0
        self.swap_wait_trace: List[float] = []   # per round trip (s)
        # the host swap pool, block-major (one host block is one contiguous
        # slab of every layer's rows): K and V (blocks, L, bs, KV, hd), pos
        # (blocks, bs); pinned on the card, so its copies do not block
        self._host_pool: Dict[str, torch.Tensor] = {}
        if self.swap:
            for k in POOL_KEYS:
                v = self.cache[k]
                rest = v.shape[1:] if k == "pos" else v.shape[:1] \
                    + v.shape[2:]
                self._host_pool[k] = torch.empty(
                    (serve.swap_space_blocks,) + tuple(rest), dtype=v.dtype,
                    pin_memory=self.device.type == "cuda")
        # contiguous-layout row copies (promotion/compaction/eviction);
        # stays 0 under paged_kv (DESIGN §9), where copy_bytes counts the
        # copy-on-write block duplications (DESIGN §10)
        self.copy_rows = 0
        self.copy_bytes = 0
        # the model's bytes, as the reference counts its global arrays: the
        # whole model's cache shapes (under a mesh a rank holds its share
        # of the K/V heads or head_dim, of the cross K/V and of the state)
        whole = init_paged_cache(
            self.cfg, 1, serve.block_size, model.dtype, "meta", n_slots=1,
            enc_len=self.enc_len) if self.paged else init_cache(
            self.cfg, 1, max_context, model.dtype, "meta",
            chunk=prefill_chunk, enc_len=self.enc_len)
        self._row_bytes = 0 if self.paged else sum(
            (v[:, 0].numel() if k != "pos" else v[0].numel())
            * v.element_size() for k, v in whole.items())
        # per-block pool bytes: the unit a copy-on-write duplicates
        self._blk_bytes = sum(
            (v[0].numel() if k == "pos" else v[:, 0].numel())
            * v.element_size()
            for k, v in whole.items() if k in POOL_KEYS) \
            if self.paged else 0
        self.decode_steps = 0
        self.batch_trace: List[int] = []
        self.tbt_trace: List[float] = []
        self.ttft_trace: List[float] = []
        # SLA attainment: decode steps within d_sla + eps_d
        self._sla_ok = 0
        self._sla_steps = 0
        # rid -> device scalar of the request's newest not-yet-retired token
        # (a first token promoted this interval feeds this interval's decode)
        self._pending_tok: Dict[int, torch.Tensor] = {}
        # rid -> life generation, bumped by _evict: retirement drops
        # patches recorded against an earlier (cleared) life
        self._gen: Dict[int, int] = {}
        # per step(): device_s = the retirement waits (the only syncs),
        # host_s = the remainder
        self.step_host_trace: List[float] = []
        self.step_device_trace: List[float] = []
        # one record a busy step(), index-aligned with step_host_trace, and
        # the submitted requests (trace.py); spans live while a profiler is
        # collecting, decided once a busy step()
        self.trace = EngineTrace()
        self._spans = False
        self._replays = 0         # step runs, for `Interval.replays`

    # -- cache rows (contiguous layout) -----------------------------------------
    def _rows_view(self, start: int, n: int) -> Dict[str, torch.Tensor]:
        """Rows [start, start + n) of the contiguous cache as VIEWS: a step
        run on them writes the cache in place — no take/put copy."""
        return cache_rows(self.cache, slice(start, start + n))

    def _clear_state(self, i: int) -> None:
        """Zero row i's per-request state (all a paged slot needs)."""
        for k in STATE_KEYS:
            if k in self.cache:
                self.cache[k][:, i] = 0

    def _clear_row(self, i: int) -> None:
        """Forget row i's contents: empty positions mask its stale K/V, and
        its state starts from zero."""
        if "pos" in self.cache:
            self.cache["pos"][i] = -1
        self._clear_state(i)

    def _copy_row(self, dst: int, src: int) -> None:
        put_cache_rows(self.cache, dst, cache_rows(self.cache, src))
        self.copy_rows += 1
        self.copy_bytes += self._row_bytes

    def _acquire_slot(self, r: Request) -> None:
        """Paged mode: pin a zeroed state slot for the request's life."""
        r.slot = self._free_slots.pop()
        self._clear_state(r.slot)

    # -- paged-mode helpers (DESIGN §9) -------------------------------------------
    def _block_tables(self, reqs, rows: int) -> np.ndarray:
        """Host block tables for a step of `rows` rows: row i holds request
        i's physical block ids from the BlockManager, -1-padded."""
        tbl = np.full((rows, self.max_blocks), -1, np.int32)
        for i, r in enumerate(reqs):
            ids = self.blocks.table(r.rid)
            tbl[i, :len(ids)] = ids
        return tbl

    def _ids(self, ids) -> torch.Tensor:
        """Host ids as a device int64 tensor, staged through the open
        arena without blocking."""
        t = torch.empty(len(ids), dtype=torch.int64, device=self.device)
        self._staging.copy(t, np.fromiter(ids, np.int64, len(ids)))
        return t

    def _release_blocks(self, freed: List[int]) -> None:
        """Clear the pos-pool rows of freed blocks so a future tenant never
        sees stale positions (DESIGN §9)."""
        if freed and "pos" in self.cache:
            self.cache["pos"].index_fill_(0, self._ids(freed), -1)

    def _drain_released(self) -> None:
        """Clear the pos rows of blocks the allocator evicted from the
        prefix cache for reuse (DESIGN §10), before the first attention
        read over a table that holds them."""
        self._release_blocks(self.blocks.take_released())

    def _cow_blocks(self, pairs: List[Tuple[int, int]]) -> None:
        """Copy-on-write (DESIGN §10, `BlockManager.cow_range`): copy the
        K, V and pos rows of each shared source block into its private
        copy, in place. Block-aligned suffixes keep this off the
        steady-state path."""
        if not pairs:
            return
        src = self._ids([a for a, _ in pairs])
        dst = self._ids([b for _, b in pairs])
        for k in POOL_KEYS:
            ax = 0 if k == "pos" else 1
            v = self.cache[k]
            v.index_copy_(ax, dst, v.index_select(ax, src))
        self.copy_bytes += self._blk_bytes * len(pairs)

    def _free_request(self, r: Request) -> None:
        """Release a request's blocks (a decref under prefix sharing:
        cached blocks keep their pos rows, DESIGN §10); in paged mode
        clear the truly freed blocks' pos rows and return its state slot
        (DESIGN §9)."""
        freed = self.blocks.free(r.rid)
        self._pending_tok.pop(r.rid, None)
        if not self.paged:
            return
        self._release_blocks(freed)
        if r.slot >= 0:
            self._free_slots.append(r.slot)
            r.slot = -1

    # -- compiled steps (graphs.py) -----------------------------------------------
    def _step(self, key: Tuple) -> Step:
        """The step of shape key `key`, built (and on the card captured) at
        first use: ("decode", bucket) or ("chunk", rows, take, cache row),
        the cache row set only for a one-row contiguous chunk, which runs
        on a view of that row (-1 otherwise); ("xchunk", 1, take, cache
        row): a first chunk that carries its request's extras; ("mixed",
        bucket, chunks): a decode bucket and that many lane chunks in one
        forward."""
        st = self.graphs.steps.get(key)
        if st is None:
            st = self._build_step(key)
            if self.graphs.enabled:
                with self._state_kept(st):
                    self.graphs.capture(st)
            self.graphs.steps[key] = st
        return st

    def _run(self, st: Step) -> torch.Tensor:
        """`st.run()` inside its span, named by the shape key's first
        element (`trace.STEP_SPANS`), counted in `_replays`."""
        self._replays += 1
        with span(self._spans, STEP_SPANS[st.key[0]]):
            return st.run()

    def _build_step(self, key: Tuple) -> Step:
        """Static inputs holding an all-padding step (positions -1, empty
        tables, the sentinel state slot, or the lane rows of a contiguous
        multi-row chunk), which writes no visible slot, and the function
        that runs the model on them at fixed cache addresses."""
        if key[0] == "mixed":
            return self._build_mixed(*key[1:])
        decode = key[0] == "decode"
        rows, take = (key[1], 1) if decode else key[1:3]
        row = -1 if decode else key[3]
        dev = self.device
        inp = {"tokens": torch.zeros((rows, take), dtype=torch.int64,
                                     device=dev),
               "positions": torch.full((rows, take), -1, dtype=torch.int32,
                                       device=dev)}
        if key[0] == "xchunk":
            inp["extras"] = torch.zeros(self._extras_shape,
                                        dtype=self.model.dtype, device=dev)

        def extras(i):
            return {extras_key(self.cfg): i["extras"]} if "extras" in i \
                else None

        m, p = self.model, self.params
        kept = None
        if self.paged:
            inp["block_table"] = torch.full((rows, self.max_blocks), -1,
                                            dtype=torch.int32, device=dev)
            inp["slots"] = torch.full((rows,), self.n_slots,
                                      dtype=torch.int64, device=dev)

            def fn(i):
                return m(p, i["tokens"], i["positions"], self.cache,
                         decode=decode, last_only=not decode,
                         tables=i["block_table"], rows=i["slots"],
                         extras=extras(i))[0][:, -1]
        elif decode or row >= 0:
            start = 0 if decode else row
            kept = slice(start, start + rows)
            view = self._rows_view(start, rows)

            def fn(i):
                return m(p, i["tokens"], i["positions"], view, decode=decode,
                         last_only=not decode, extras=extras(i))[0][:, -1]
        else:
            # lane rows need not be adjacent: gather, run, scatter back
            # (the cross K/V rows are only read here)
            kept = slice(self.max_slots, self.max_slots + rows)
            inp["slots"] = torch.arange(kept.start, kept.stop, device=dev)

            def fn(i):
                sub = cache_rows(self.cache, i["slots"])
                logits, sub = m(p, i["tokens"], i["positions"], sub,
                                last_only=True)
                put_cache_rows(self.cache, i["slots"], {
                    k: v for k, v in sub.items() if k not in CROSS_KEYS})
                return logits[:, -1]
        return Step(key, inp, fn, cache_rows=kept)

    def _build_mixed(self, bucket: int, n: int) -> Step:
        """A mixed step's static inputs, all padding: `bucket` decode rows
        of one token, then `n` chunk rows of `prefill_chunk` tokens, in one
        row of tokens (`layers.MixedRows`), and one block table a row.
        Returns the logits of the decode rows."""
        C, dev = self.prefill_chunk, self.device
        width = bucket + n * C
        inp = {"tokens": torch.zeros((1, width), dtype=torch.int64,
                                     device=dev),
               "positions": torch.full((1, width), -1, dtype=torch.int32,
                                       device=dev),
               "block_table": torch.full((bucket + n, self.max_blocks), -1,
                                         dtype=torch.int32, device=dev)}
        m, p = self.model, self.params

        def fn(i):
            rows = MixedRows(bucket, C, i["block_table"])
            return m(p, i["tokens"], i["positions"], self.cache,
                     tables=rows)[0][0]
        return Step(("mixed", bucket, n), inp, fn)

    @contextlib.contextmanager
    def _state_kept(self, st: Step):
        """Keep the per-request state of the contiguous rows `st` writes
        across the eager runs that precede its capture: an all-padding step
        writes no K/V or position, but the recurrent layers step every
        row's state, and an extras step writes its row's cross K/V (from
        the encoder run on zeros). A paged step's padding rows hold the
        sentinel slot, which no step writes."""
        rows = st.cache_rows
        keys = STATE_KEYS + (CROSS_KEYS if "extras" in st.inputs else ())
        kept = {} if rows is None else {
            k: self.cache[k][:, rows].clone() for k in keys
            if k in self.cache}
        yield
        for k, v in kept.items():
            self.cache[k][:, rows] = v

    def _stage(self, st: Step, name: str, host: np.ndarray) -> None:
        """Stage `host` into the step input `name`. Block tables and state
        slots are copied again only when they changed since the step last
        ran, as the reference caches its device tables per call site and
        shape."""
        if name in ("block_table", "slots"):
            last = st.host.get(name)
            if last is not None and np.array_equal(last, host):
                return
            st.host[name] = host
        self._staging.copy(st.inputs[name], host)

    def warmup(self) -> None:
        """Build, and on the card capture, every decode bucket (and its
        mixed steps, one to `n_prefill_lanes` chunks) and every full-chunk
        lane shape ahead of time (the reference's `Engine.warmup`); tail
        chunks are captured at first use. The all-padding steps change no
        visible cache slot."""
        keys = [("decode", b) for b in self.buckets]
        if self.mixed:
            keys += [("mixed", b, n) for b in self.buckets
                     for n in range(1, self.n_lanes + 1)]
        C = self.prefill_chunk
        if self.paged:
            groups = range(1, self.n_lanes + 1) \
                if self.serve.chunked_prefill else (1,)
            keys += [("chunk", g, C, -1) for g in groups]
            ones = [-1]
        elif self.serve.chunked_prefill:
            ones = [self.max_slots + j for j in range(self.n_lanes)]
            keys += [("chunk", 1, C, r) for r in ones]
            keys += [("chunk", g, C, -1) for g in range(2, self.n_lanes + 1)]
        else:
            ones = list(range(self.max_slots))
            keys += [("chunk", 1, C, r) for r in ones]
        if self.enc_len:
            # a full first chunk with extras, on each row one may take
            keys += [("xchunk", 1, C, r) for r in ones]
        for key in keys:
            self._step(key)

    # -- public API -------------------------------------------------------------
    def submit(self, prompt_tokens: List[int], max_new_tokens: int = 0,
               extras: Optional[Dict[str, object]] = None,
               arrival_time: Optional[float] = None) -> Request:
        """Queue a request. `extras` (VLM {"images": ...}, enc-dec
        {"enc_frames": ...}, (1, enc_len, d), a tensor or an array of any
        float type) are cast to the working dtype and kept on the host for
        the request's life."""
        if arrival_time is None:
            self._fresh_clock()
        t = arrival_time if arrival_time is not None else self._now()
        mx = max_new_tokens or self.serve.max_new_tokens
        mx = min(mx, self.max_context - len(prompt_tokens) - 1)
        r = Request(rid=self._next_rid, arrival_time=t,
                    prompt_tokens=list(prompt_tokens), max_new_tokens=mx)
        if extras is not None:
            r.extras = self._host_extras(extras)
        self._next_rid += 1
        self.waiting.append(r)
        self.trace.requests.append(r)
        self.tel.on_arrival(t, r.prompt_len)
        return r

    def _host_extras(self, extras: Dict[str, object]) -> torch.Tensor:
        """A request's extras as one (1, enc_len, d) host tensor in the
        working dtype; raises for a family without them, another key or
        another shape."""
        if not self.enc_len:
            raise ValueError(f"{self.cfg.name} takes no extras")
        key = extras_key(self.cfg)
        if set(extras) != {key}:
            raise ValueError(f"{self.cfg.name} takes extras {key!r}, got "
                             f"{sorted(extras)}")
        x = extras[key]
        x = x if isinstance(x, torch.Tensor) \
            else torch.as_tensor(x, dtype=torch.float32)
        if tuple(x.shape) != self._extras_shape:
            raise ValueError(f"extras {key!r} of shape {tuple(x.shape)}, "
                             f"not {self._extras_shape}")
        return x.detach().to("cpu", self.model.dtype).contiguous()

    def _now(self) -> float:
        """Seconds since the engine was built; under a mesh the clock rank
        0 read at the last agreement (`_agree`, `_fresh_clock`), the same
        on every rank and late by at most one interval's host time
        (docs/PORT.md, "Tensor-parallel serving")."""
        if self.group is not None:
            return self._agreed_now
        return time.perf_counter() - self.now0

    def _fresh_clock(self) -> None:
        """Under a mesh, the first stamp after an idle stretch (the
        engine's build or a drain, however long) agrees rank 0's clock
        afresh: one broadcast on the control group, at a `submit` that
        stamps an arrival or at the top of a busy `step()`, whichever
        comes first. The stamps that follow read it, idle time included,
        where the clock agreed at the drain would make them early by the
        whole idle time. Busy intervals keep their one agreement each
        (`_agree`); every rank submits and steps alike, so the broadcasts
        match."""
        if self.group is not None and self._clock_stale:
            self._agreed_now = self.group.agree(
                [time.perf_counter() - self.now0])[0]
            self._clock_stale = False

    def _agree(self, t0: float, n: int) -> Optional[float]:
        """Under a mesh, the interval's one agreement: wait for the n
        oldest in-flight intervals' events, then broadcast rank 0's clock,
        host seconds since `t0` and those waits on the control group.
        The clock and the waits (which `_retire_step` takes in order) are
        set; returns the host seconds, or None without a mesh."""
        if self.group is None:
            return None
        waits = []
        for rec in list(self._inflight)[:max(n, 0)]:
            t = time.perf_counter()
            if rec.event is not None:
                rec.event.synchronize()
            waits.append(time.perf_counter() - t)
        now = time.perf_counter() - self.now0
        host_s = (time.perf_counter() - t0) - sum(waits)
        vals = self.group.agree([now, host_s] + waits)
        self._agreed_now = vals[0]
        self._agreed_waits.extend(vals[2:])
        return vals[1]

    def run(self, max_steps: int = 100_000) -> int:
        steps = 0
        while self.step() and steps < max_steps:
            steps += 1
        return steps

    # -- scheduling interval -------------------------------------------------------
    def step(self) -> bool:
        """One scheduling interval: admit, prefill, decode and dispatch the
        readback, then retire the oldest intervals until at most
        `overlap_depth` remain in flight (DESIGN §14). Returns False when
        fully idle."""
        if not self.waiting and not self.active and not self.prefilling \
                and not self.swapped:
            # pipeline drain: retirement only patches values, timestamps
            # and telemetry, never schedulable work, so this call still
            # reports idle and run() counts the synchronous loop's steps
            self._agree(time.perf_counter(), len(self._inflight))
            self._spans = False
            while self._inflight:
                self._retire_step()
            self._clock_stale = True
            return False
        self._fresh_clock()
        on = self._spans = torch.autograd._profiler_enabled()
        with span(on, "engine.step"):
            self._interval(on)
        return True

    def _interval(self, on: bool) -> None:
        """The busy part of `step()`; `on`: spans and device timing."""
        t0 = time.perf_counter()
        replays0 = self._replays
        rec = _StepRec()
        if on and self.device.type == "cuda":
            # the interval's device time starts before any of its work
            rec.start = torch.cuda.Event(enable_timing=True)
            rec.start.record()
        now, t_now = self._now(), time.perf_counter()
        rec.interval = iv = Interval(now)
        with span(on, "engine.schedule"):
            tel = self.tel.snapshot(
                now=now,
                n_prefill=len(self.waiting) + len(self.prefilling),
                n_decode=len(self.active),
                free_tokens=self.blocks.free_tokens,
                logical_used_tokens=self.blocks.logical_used_tokens,
                physical_used_tokens=self.blocks.physical_used_tokens,
                swapped_tokens=self.blocks.swapped_tokens)
            decision = self.policy.step(tel)
        # sim-mirrored admission (DESIGN §7): the controller's cap rounded
        # to the batch buckets, gated by the shared admission verdict
        cap = bucketize(decision.max_batch, self.serve.batch_buckets) \
            if self.serve.batch_buckets else decision.max_batch
        cap = min(cap, decision.max_batch, self.max_slots)
        with span(on, "engine.admit"):
            self._admit(cap, rec)

        if self.serve.chunked_prefill:
            # PD fusion: one fused interval = prefill chunks (within the
            # controller's token budget) + the decode batch
            budget = decision.chunk_budget \
                or self.serve.chunk_budget_tokens
            if budget <= 0 and self.prefilling and not self.active:
                # nothing decoding and no token budget: make minimum
                # progress on one full chunk instead of livelocking
                budget = self.prefill_chunk
            if self.prefilling:
                iv.chunk_budget = budget
            with span(on, "engine.prefill"):
                self._advance_prefill(budget, rec)
        if self.active:
            with span(on, "engine.decode"):
                self._decode_once(rec)
        if rec.dispatched:
            with span(on, "engine.readback"):
                self._dispatch_readback(rec)
            self._inflight.append(rec)
        agreed_host_s = self._agree(
            t0, len(self._inflight) - self.overlap_depth)
        device_s = 0.0
        while len(self._inflight) > self.overlap_depth:
            with span(on, "engine.retire"):
                device_s += self._retire_step()
        t1 = time.perf_counter()
        host_s = (t1 - t0) - device_s \
            if agreed_host_s is None else agreed_host_s
        iv.n_decode, iv.prefill_tokens = rec.n_decode, rec.prefill_tokens
        iv.replays = self._replays - replays0
        # the engine clock at t1: from its reading, not from t0, so that an
        # interval ends before the next one's start
        iv.t_end = now + (t1 - t_now)
        self.step_host_trace.append(host_s)
        self.step_device_trace.append(device_s)
        self.trace.intervals.append(iv)

    def _admit(self, cap: int, rec: _StepRec) -> None:
        """Swap-ins, then admissions from `waiting` up to `cap` running
        requests (prefix sharing, the pool's verdict), then the released
        blocks' position rows and the preemptions the next decode step's
        growth needs."""
        # swap-in drain (DESIGN §11): offloaded requests re-enter before
        # any admission, and while any remain `waiting` is held back
        while self.swapped \
                and len(self.active) + len(self.prefilling) < cap:
            if not self._swap_in_next():
                self.oom_events += 1
                break

        while self.waiting and not self.swapped \
                and len(self.active) + len(self.prefilling) < cap:
            r = self.waiting[0]
            # a state-only request holds one block: an admission cap
            need = self.serve.block_size if self.state_only \
                else r.prompt_len + 1
            # prefix sharing (DESIGN §10): map the indexed full prompt
            # blocks first, then gate on the unmatched suffix (rolled back
            # on refusal)
            cached = 0
            if self.prefix and r.prompt_tokens:
                cached = self.blocks.acquire_prefix(r.rid, r.prompt_tokens)
            nb = self.blocks.blocks_needed(0, need, r.rid)
            mb = self.max_blocks - len(self.blocks.table(r.rid))
            verdict = "reject" if mb <= 0 and nb > 0 \
                else self.blocks.admission_verdict(nb, mb)
            if verdict != "admit":
                if cached:
                    self.blocks.free(r.rid)
                if verdict == "reject":
                    # no pool state can ever hold it: drop it rather than
                    # wedging the queue behind it
                    self.waiting.pop(0)
                    r.state = RequestState.FINISHED
                    r.rejected = True
                    r.finish_time = self._now()
                    r.stamp_sla(self.serve.ttft_sla_s, self.serve.tbt_sla_ms)
                    self.rejected += 1
                    continue
                self.oom_events += 1
                break
            self.blocks.allocate(r.rid, 0, need)
            if self.prefix:
                self.blocks.note_prefix_query(r.prompt_len, cached)
            r.cached_prefix_len = cached
            self.waiting.pop(0)
            self.admitted_total += 1
            if self.serve.chunked_prefill:
                r.state = RequestState.PREFILLING
                r.prefill_pos = cached
                self.prefilling.append(r)
            else:
                self._prefill_request(r, rec)
        self._drain_released()
        self._preempt_if_needed()

    # -- PD fusion internals (DESIGN §6) ---------------------------------------
    def _fill_lanes(self):
        """Assign queued prefilling requests to free lanes (sticky: a lane
        keeps its request until promotion)."""
        queued = [(None, r) for r in self.prefilling if r.lane < 0]
        if not queued:
            return
        queued = lane_order(self.serve.prefill_pack, queued)
        for j in range(self.n_lanes):
            if self.lanes[j] is not None:
                continue
            if not queued:
                break
            _, r = queued.pop(0)
            if self.paged:
                self._acquire_slot(r)
            else:
                r.slot = self.max_slots + j
                self._clear_row(r.slot)
            r.lane = j
            self.lanes[j] = r

    def _prefill_group(self, reqs: List[Request], take: int,
                       extras: bool = False) -> torch.Tensor:
        """One prefill chunk of `take` tokens for each request (same-size
        lane chunks batched into one step; `extras`: one request's first
        chunk, its extras staged into the step). Returns each row's greedy
        next token (len(reqs),) on the device: the step's logits are
        consumed here, before any other step runs (the graphs share one
        pool)."""
        g = len(reqs)
        row = reqs[0].slot if g == 1 and not self.paged else -1
        st = self._step(("xchunk" if extras else "chunk", g, take, row))
        if extras:
            self._stage(st, "extras", reqs[0].extras)
        self._stage(st, "tokens", np.array(
            [r.prompt_tokens[r.prefill_pos:r.prefill_pos + take]
             for r in reqs], np.int64))
        start = np.fromiter((r.prefill_pos for r in reqs), np.int32, g)
        self._stage(st, "positions",
                    start[:, None] + np.arange(take, dtype=np.int32))
        if self.paged:
            self._stage(st, "block_table", self._block_tables(reqs, g))
        if "slots" in st.inputs:
            self._stage(st, "slots", np.fromiter((r.slot for r in reqs),
                                                 np.int64, g))
        return self._run(st).argmax(-1)

    def _advance_prefill(self, budget_tokens: int, rec: _StepRec) -> None:
        """Advance up to n_prefill_lanes prefilling requests by one chunk
        each, within the interval's token budget (core.lanes.pack_chunks),
        and promote the lanes that finish their prompt."""
        if not self.prefilling or budget_tokens <= 0:
            return
        self._fill_lanes()
        plan = pack_chunks(self.serve.prefill_pack, self.lanes,
                           budget_tokens, self.prefill_chunk)
        if not plan:
            return
        for _, r, _ in plan:
            if r.prefill_start_time < 0:
                r.prefill_start_time = self._now()
        if self.prefix:
            # copy-on-write guard on each chunk's write range (DESIGN §10)
            for _, r, take in plan:
                self._cow_blocks(self.blocks.cow_range(
                    r.rid, r.prefill_pos, r.prefill_pos + take))
        # same-size chunks run as one multi-row step; a first chunk that
        # carries extras (they differ per request) runs alone, first. In an
        # interval that decodes, a lane that does not finish its prompt
        # runs its chunk in the mixed step (`_decode_once`); a finishing
        # lane's chunk runs here, so its request decodes this interval
        decodes = bool(self.active) or any(
            r.prefill_pos + t >= r.prompt_len for _, r, t in plan)
        first_tok: Dict[int, torch.Tensor] = {}   # lane -> next token
        groups: Dict[int, list] = {}
        for j, r, t in plan:
            if r.prefill_pos == 0 and r.extras is not None:
                toks = self._prefill_group([r], t, extras=True)
                rec.dispatched = True
                rec.probe = toks
                first_tok[j] = toks[0]
            elif self.mixed and decodes \
                    and r.prefill_pos + t < r.prompt_len:
                rec.lanes.append((r, r.prefill_pos, t))
            else:
                groups.setdefault(t, []).append((j, r))
        for take, entries in groups.items():
            toks = self._prefill_group([r for _, r in entries], take)
            rec.dispatched = True
            rec.probe = toks
            for i, (j, _) in enumerate(entries):
                first_tok[j] = toks[i]

        rec.lane_tokens = {j: t for j, _, t in plan}
        rec.prefill_tokens += sum(rec.lane_tokens.values())
        for _, r, take in plan:
            r.prefill_pos += take
            if self.prefix:
                # the chunk's K/V is dispatched (a mixed step's, this
                # interval, before any later admission can map it): index
                # its full blocks
                self.blocks.commit_prefill(r.rid, r.prompt_tokens,
                                           r.prefill_pos)
        # promote finished lanes in lane-index order (deterministic): paged
        # mode is a bookkeeping move; contiguous mode copies the lane row
        # into the compacted decode region
        for j, r, _ in sorted(plan, key=lambda e: e[0]):
            if r.prefill_pos < r.prompt_len:
                continue
            self.prefilling.remove(r)
            self.lanes[j] = None
            if not self.paged:
                dst = len(self.active)
                self._copy_row(dst, r.slot)
                r.slot = dst
            r.lane = -1
            r.state = RequestState.RUNNING
            self._emit_first(r, first_tok[j], rec, feed=True)
            self.active.append(r)

    def _emit_first(self, r: Request, tok: torch.Tensor, rec: _StepRec,
                    feed: bool) -> None:
        """The first token (the prompt's greedy next token) stays on the
        device until retirement; the decode step of this same interval
        reads it from `_pending_tok`."""
        rec.patches.append((r, len(r.output_tokens), self._gen.get(r.rid, 0),
                            "f", len(rec.first)))
        rec.first.append(tok)
        self._pending_tok[r.rid] = tok
        rec.firsts.append((r, feed, r.prefill_start_time - r.arrival_time,
                           r.prefill_start_time))
        r.output_tokens.append(None)
        rec.dispatched = True
        rec.probe = tok

    # -- internals ---------------------------------------------------------------
    def _prefill_request(self, r: Request, rec: _StepRec):
        """Non-chunked admission: prefill the whole prompt now, in
        exact-size chunks of `prefill_chunk` tokens; under prefix sharing
        only the suffix past the shared blocks (DESIGN §10)."""
        # blocks admission evicted from the prefix cache into this table
        # lose their stale pos rows before the first attention read
        self._drain_released()
        start0 = r.cached_prefix_len if self.prefix else 0
        if self.prefix:
            self._cow_blocks(self.blocks.cow_range(r.rid, start0,
                                                   r.prompt_len))
        if self.paged:
            self._acquire_slot(r)
        else:
            r.slot = len(self.active)
            self._clear_row(r.slot)
        r.state = RequestState.PREFILLING
        rec.prefill_tokens += r.prompt_len - start0
        tok = None
        for start in range(start0, r.prompt_len, self.prefill_chunk):
            r.prefill_pos = start
            take = min(self.prefill_chunk, r.prompt_len - start)
            tok = self._prefill_group(
                [r], take, extras=start == 0 and r.extras is not None)[0]
        r.prefill_pos = r.prompt_len
        if self.prefix:
            self.blocks.commit_prefill(r.rid, r.prompt_tokens, r.prompt_len)
        r.state = RequestState.RUNNING
        # the synchronous path feeds no TTFT split (no chunked service)
        self._emit_first(r, tok, rec, feed=False)
        self.active.append(r)

    def _preempt_if_needed(self):
        """Preempt the newest request until the next decode step's block
        growth fits the pool (vLLM order, in both modes); per victim the
        DESIGN §11 crossover picks swap or recompute. A state-only
        family's decode never grows, so it never preempts."""
        if self.state_only:
            return
        while self.active:
            need = sum(self.blocks.blocks_needed(r.context_len, 1, r.rid)
                       for r in self.active)
            if need <= self.blocks.free_blocks:
                return
            victim = self.active[-1]
            if self._should_swap(victim):
                self._swap_out(len(self.active) - 1, victim)
            else:
                self._evict(len(self.active) - 1, victim)

    def _should_swap(self, r: Request) -> bool:
        """Swap only when the host pool can take the victim whole (shared
        blocks are never swapped: such a victim recomputes) and the cost
        model's crossover says the PCIe round trip beats re-prefill;
        preempt="swap" swaps whenever it can (DESIGN §11)."""
        if not self.swap \
                or not self.blocks.can_swap_out(r.rid, self.max_blocks):
            return False
        if self.serve.preempt == "swap":
            return True
        return self.cost.swap_beats_recompute(
            len(self.blocks.table(r.rid)), self.serve.block_size,
            r.context_len)

    def _swap_out(self, slot: int, r: Request) -> None:
        """Offload active[slot]'s K, V and pos pool rows to the host pool
        (DESIGN §11): gathered on the device in host-id order into one
        block-major buffer, each run of consecutive host blocks one
        non-blocking copy. The stream orders the copies after every step
        that wrote the rows and before any reuse of the freed blocks. Its
        generated tokens, pending token and TTFT stand; it re-enters
        through `swapped` without re-prefill, in the same life."""
        pairs = sorted(self.blocks.swap_out(r.rid), key=lambda p: p[1])
        host = [h for _, h in pairs]
        ids = self._ids([d for d, _ in pairs])
        for k, hp in self._host_pool.items():
            v = self.cache[k]
            rows = v.index_select(0, ids) if k == "pos" \
                else v.index_select(1, ids).transpose(0, 1).contiguous()
            for a, b, h0 in host_runs(host):
                hp[h0:h0 + b - a].copy_(rows[a:b], non_blocking=True)
        # the device blocks are free: a new tenant must not see the swapped
        # tenant's positions
        self._release_blocks([d for d, _ in pairs])
        # model-level K/V payload bytes, the sim twin's and the cost
        # model's unit
        self.swap_out_bytes += self.mem.blocks_to_bytes(len(pairs))
        self.swap_outs += 1
        self.preemptions += 1
        r.state = RequestState.SWAPPED
        r.swap_out_time = self._now()
        if r.slot >= 0:
            self._free_slots.append(r.slot)
            r.slot = -1
        self.active.pop(slot)
        self.swapped.append(r)

    def _swap_in_next(self) -> bool:
        """Restore the oldest swapped request (FIFO) onto fresh device
        blocks, gated by admission's watermark verdict: the host runs are
        copied without blocking into one device buffer and scattered into
        the pools in place. Returns False when the pool cannot take it
        yet."""
        r = self.swapped[0]
        nb = len(self.blocks.swapped_block_tables[r.rid])
        if self.blocks.admission_verdict(nb, self.max_blocks) != "admit":
            return False
        pairs = sorted(self.blocks.swap_in(r.rid))
        # pos clears of cache evictions swap_in forced land before the
        # restore, so they cannot wipe restored rows
        self._drain_released()
        host = [h for h, _ in pairs]
        ids = self._ids([d for _, d in pairs])
        for k, hp in self._host_pool.items():
            buf = torch.empty((len(pairs),) + hp.shape[1:], dtype=hp.dtype,
                              device=self.device)
            for a, b, h0 in host_runs(host):
                buf[a:b].copy_(hp[h0:h0 + b - a], non_blocking=True)
            if k == "pos":
                self.cache[k].index_copy_(0, ids, buf)
            else:
                self.cache[k].index_copy_(1, ids, buf.transpose(0, 1))
        self.swap_in_bytes += self.mem.blocks_to_bytes(len(pairs))
        self.swap_ins += 1
        self._acquire_slot(r)
        if r.swap_out_time >= 0:
            wait = self._now() - r.swap_out_time
            r.swapped_s += wait
            r.n_swaps += 1
            r.swap_out_time = -1.0
            self.swap_wait_trace.append(wait)
        r.state = RequestState.RUNNING
        self.swapped.pop(0)
        self.active.append(r)
        return True

    def _evict(self, slot: int, r: Request):
        """Evict active[slot] for recompute: paged mode releases blocks,
        contiguous mode compacts by moving the last row into the hole."""
        self._free_request(r)
        r.state = RequestState.WAITING
        # a new life: patches recorded against the cleared outputs drop
        self._gen[r.rid] = self._gen.get(r.rid, 0) + 1
        r.output_tokens.clear()
        r.tbt_samples.clear()
        # the recompute pass re-probes the prefix index (DESIGN §10)
        r.cached_prefix_len = 0
        r.prefill_start_time = -1.0
        self._remove_active(slot)
        self.waiting.insert(0, r)
        self.preemptions += 1

    def _remove_active(self, i: int) -> None:
        if self.paged:
            self.active.pop(i)
            return
        last = len(self.active) - 1
        if i != last:
            self._copy_row(i, last)
            self.active[i] = self.active[last]
            self.active[i].slot = i
        self.active.pop()

    def _decode_once(self, rec: _StepRec):
        """The interval's decode step over `active`, in its bucket; with
        `rec.lanes` the mixed step of that bucket and that many chunk
        rows."""
        if self.prefix:
            # copy-on-write guard on the position each row writes
            for r in self.active:
                self._cow_blocks(self.blocks.cow_range(
                    r.rid, r.context_len - 1, r.context_len))
        n = len(self.active)
        ge = [b for b in self.buckets if b >= n]
        bucket = min(ge) if ge else self.max_slots
        st = self._step(("mixed", bucket, len(rec.lanes)) if rec.lanes
                        else ("decode", bucket))
        toks = np.zeros((bucket, 1), np.int64)
        # the pending token sits at absolute position context_len - 1
        lens = np.full((bucket, 1), -1, np.int32)
        pend = []    # rows whose input is a first token still on the device
        for i, r in enumerate(self.active):
            if r.output_tokens[-1] is None:
                pend.append(i)
            else:
                toks[i, 0] = r.output_tokens[-1]
            lens[i, 0] = r.context_len - 1
        tables = self._block_tables(self.active, bucket) if self.paged \
            else None
        if rec.lanes:
            toks, lens, tables = self._lane_rows(rec.lanes, toks, lens,
                                                 tables)
        self._stage(st, "tokens", toks)
        self._stage(st, "positions", lens)
        if pend:
            idx = self._ids(pend)
            st.inputs["tokens"].view(-1).index_copy_(0, idx, torch.stack(
                [self._pending_tok[self.active[i].rid] for i in pend]))
        if self.paged:
            self._stage(st, "block_table", tables)
        if "slots" in st.inputs:
            # padding rows read the sentinel slot n_slots (zeros)
            slots = np.full(bucket, self.n_slots, np.int64)
            slots[:n] = [r.slot for r in self.active]
            self._stage(st, "slots", slots)
        logits = self._run(st)
        sampled = sample(logits[:n], self.generator, self.temperature)
        rec.dec = sampled
        rec.n_decode = n
        rec.dispatched = True
        self.batch_trace.append(n)
        self.decode_steps += 1
        self.total_decoded += n

        finished = []
        grow_failed = []
        for i, r in enumerate(self.active):
            # grow the KV footprint for the NEXT step's write; constant
            # per-request state never grows
            grew = self.state_only or \
                self.blocks.allocate(r.rid, r.context_len, 1)
            rec.patches.append((r, len(r.output_tokens),
                                self._gen.get(r.rid, 0), "d", i))
            r.output_tokens.append(None)
            self._pending_tok[r.rid] = sampled[i]
            if len(r.output_tokens) >= r.max_new_tokens \
                    or r.context_len >= self.max_context - 1:
                finished.append(i)
            elif not grew:
                # no backing block for the successor token: preempt
                grow_failed.append(r)
        for i in sorted(finished, reverse=True):
            r = self.active[i]
            r.state = RequestState.FINISHED
            rec.completions.append((r, len(r.output_tokens)))
            self._free_request(r)
            self._remove_active(i)
            self.total_finished += 1
        for r in grow_failed:
            if r in self.active:
                self._evict(self.active.index(r), r)
        # decode grows may have taken cached blocks for reuse
        self._drain_released()

    def _lane_rows(self, lanes, toks, lens, tables):
        """The mixed step's host inputs: the decode rows' tokens, positions
        and block tables followed by the chunk rows', each chunk from its
        start, padded to `prefill_chunk` tokens at position -1."""
        n, C = len(lanes), self.prefill_chunk
        lt = np.zeros((n, C), np.int64)
        lp = np.full((n, C), -1, np.int32)
        for i, (r, start, take) in enumerate(lanes):
            lt[i, :take] = r.prompt_tokens[start:start + take]
            lp[i, :take] = np.arange(start, start + take)
        return (np.concatenate([toks.ravel(), lt.ravel()])[None],
                np.concatenate([lens.ravel(), lp.ravel()])[None],
                np.concatenate([tables, self._block_tables(
                    [r for r, _, _ in lanes], n)]))

    def _dispatch_readback(self, rec: _StepRec) -> None:
        """Queue the interval's readback behind its steps: the sampled and
        first tokens (or, with neither, one token of the last prefill
        chunk, a fence) concatenated on the device and copied without
        blocking into the interval's staging arena, which is sealed to the
        record; on the card an event is recorded behind the copy."""
        toks = ([rec.dec] if rec.dec is not None else []) \
            + [t.reshape(1) for t in rec.first]
        flat = torch.cat(toks) if toks else rec.probe.reshape(-1)[:1]
        rec.host = self._staging.readback(flat)
        rec.arena = self._staging.seal()
        if self.device.type == "cuda":
            rec.event = torch.cuda.Event(enable_timing=rec.start is not None)
            rec.event.record()

    def _retire_step(self) -> float:
        """Retire the oldest in-flight interval: wait for its readback
        event, patch the output placeholders from the pinned tokens, stamp
        TTFT/TBT/finish times and apply the interval's telemetry feeds,
        rewind its staging arena and seal the allocator's shadow epoch
        (DESIGN §14, the reference's `_retire_step`). Returns the wait in
        seconds.

        The event wait is the only synchronisation of the serving loop (its
        steps are graph replays, its inputs staged without blocking), so it
        is the device time the host could not hide, and it is a decode
        step's TBT sample, as in the reference."""
        rec = self._inflight.popleft()
        t0 = time.perf_counter()
        with span(self._spans, "engine.retire.wait"):
            if rec.event is not None:
                rec.event.synchronize()
        dev_s = time.perf_counter() - t0
        if rec.start is not None:
            rec.interval.device_ms = rec.start.elapsed_time(rec.event)
        if self._agreed_waits:
            # under a mesh: rank 0's wait (`_agree` waited already)
            dev_s = self._agreed_waits.popleft()
        vals = rec.host.tolist()
        self._staging.release(rec.arena)
        dt_ms = dev_s * 1e3
        now = self._now()
        n_dec = rec.dec.shape[0] if rec.dec is not None else 0
        for r, idx, gen, kind, k in rec.patches:
            if self._gen.get(r.rid, 0) != gen:
                continue   # evicted since dispatch: recompute re-emits
            if idx < len(r.output_tokens) and r.output_tokens[idx] is None:
                r.output_tokens[idx] = vals[k if kind == "d" else n_dec + k]
            if kind == "d":
                r.tbt_samples.append(dt_ms)
        if rec.lane_tokens is not None:
            self.tel.on_prefill_interval(rec.lane_tokens, self.n_lanes)
        for r, feed, queue_s, t_ps in rec.firsts:
            r.first_token_time = now
            self.ttft_trace.append(now - r.arrival_time)
            if feed:
                self.tel.on_first_token(queue_s, now - t_ps)
        if rec.n_decode:
            self.tel.on_decode_step(dt_ms, rec.n_decode)
            self.tbt_trace.append(dt_ms)
            self._sla_steps += 1
            if self.serve.d_sla_ms <= 0 or dt_ms <= self.serve.d_sla_ms \
                    + self.serve.eps_d_ms:
                self._sla_ok += 1
        for r, n_out in rec.completions:
            r.finish_time = now
            if r.stamp_sla(self.serve.ttft_sla_s, self.serve.tbt_sla_ms):
                self.sla_requests_met += 1
                self.goodput_tokens += n_out
            self.tel.on_completion(n_out)
        # blocks freed since the last retirement are safe for any reuse
        # now that the step that could still read them has retired; open
        # the next epoch for the frees of the intervals still in flight
        self.blocks.shadow_commit()
        self.blocks.shadow_begin()
        return dev_s

    # -- metrics ---------------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        """The JAX engine's summary keys (`model_shards`: the KV pool's
        model-axis shards under a mesh, 1 without)."""
        el = self._now()
        occ = self.tel.lane_occ
        tq, _ = self.tel.ttft_queue.get()
        tp, _ = self.tel.ttft_prefill.get()
        tbts = sorted(self.tbt_trace)
        ttfts = sorted(self.ttft_trace)
        return {
            "throughput_tok_s": self.total_decoded / max(el, 1e-9),
            "total_tokens": float(self.total_decoded),
            "duration_s": el,
            "model_shards": float(self.model_shards),
            "pool_tokens": float(self.mem.eta),
            "decode_steps": self.decode_steps,
            "mean_batch": (sum(self.batch_trace) / len(self.batch_trace))
            if self.batch_trace else 0.0,
            "tbt_ms_mean": (sum(self.tbt_trace) / len(self.tbt_trace))
            if self.tbt_trace else 0.0,
            "tbt_ms_p95": tbts[int(0.95 * (len(tbts) - 1))] if tbts else 0.0,
            "sla_attainment": (self._sla_ok / self._sla_steps)
            if self._sla_steps else 0.0,
            "goodput_tok_s": self.goodput_tokens / max(el, 1e-9),
            "goodput_tokens": float(self.goodput_tokens),
            "sla_requests_met": self.sla_requests_met,
            "request_sla_attainment": self.sla_requests_met
            / max(self.total_finished + self.rejected, 1),
            "step_host_s_mean": (sum(self.step_host_trace)
                                 / len(self.step_host_trace))
            if self.step_host_trace else 0.0,
            "step_device_s_mean": (sum(self.step_device_trace)
                                   / len(self.step_device_trace))
            if self.step_device_trace else 0.0,
            "finished": self.total_finished,
            "admitted": self.admitted_total,
            "preemptions": self.preemptions,
            "oom_events": self.oom_events,
            "rejected": self.rejected,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "swap_out_bytes": float(self.swap_out_bytes),
            "swap_in_bytes": float(self.swap_in_bytes),
            "swapped_peak": float(self.blocks.swapped_peak),
            "swap_latency_s_mean": (sum(self.swap_wait_trace)
                                    / len(self.swap_wait_trace))
            if self.swap_wait_trace else 0.0,
            "copy_rows": float(self.copy_rows),
            "copy_bytes": float(self.copy_bytes),
            "prefix_hit_rate": self.blocks.prefix_hit_rate,
            "prefix_hit_tokens": float(self.blocks.prefix_hit_tokens),
            "prefix_query_tokens": float(self.blocks.prefix_query_tokens),
            "cached_blocks": float(self.blocks.cached_blocks),
            "cache_evictions": float(self.blocks.cache_evictions),
            "logical_used_tokens": float(self.blocks.logical_used_tokens),
            "physical_used_tokens": float(self.blocks.physical_used_tokens),
            "logical_used_bytes": float(self.mem.tokens_to_bytes(
                self.blocks.logical_used_tokens)),
            "physical_used_bytes": float(self.mem.tokens_to_bytes(
                self.blocks.physical_used_tokens)),
            "prefill_lane_occupancy": (sum(occ) / len(occ)) if occ else 0.0,
            "prefill_tokens": float(self.tel.prefill_tokens_total),
            "ttft_queue_s_mean": tq,
            "ttft_prefill_s_mean": tp,
            "ttft_mean_s": (sum(ttfts) / len(ttfts)) if ttfts else 0.0,
            "ttft_p90_s": ttfts[int(0.9 * (len(ttfts) - 1))]
            if ttfts else 0.0,
        }
