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

Per-request state (DESIGN §9; SSM conv/ssm, RG-LRU conv/rec) is a cache row
per slot. In the contiguous layout it moves with the K/V row. In the paged
layout a request pins a state slot from `_free_slots` for its whole life;
decode reads the slots of the active requests and pads the bucket with the
sentinel slot, which reads zeros and is never written. State-only families
(no K/V: `mem.bytes_per_token == 0`) hold one block per request as an
admission cap, never grow it, and never preempt.

Every decode step and prefill chunk is a `graphs.Step` per shape key, the
counterpart of the reference's `jax.jit` per shape: on the card the replay
of a CUDA graph captured once (`warmup()` captures every decode bucket and
full-chunk lane shape; tail chunks capture at first use), on the CPU the
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
returns. Prefix sharing, the swap tier and mesh serving are not ported yet
and raise when asked for.
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
from repro_torch.core.memory_model import MemoryModel
from repro_torch.core.telemetry import Telemetry
from repro_torch.models.backbone import STATE_KEYS
from repro_torch.models.model import Model, resolve_device
from repro_torch.serving.graphs import Staging, Step, StepGraphs
from repro_torch.serving.kv_cache import BlockManager
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.sampling import sample


def cache_rows(cache: Dict[str, torch.Tensor],
               rows) -> Dict[str, torch.Tensor]:
    """Rows `rows` (an int, a slice or an index tensor) of a contiguous
    cache: `pos` has its rows on axis 0, every other key on axis 1. An int
    or a slice gives views."""
    return {k: v[rows] if k == "pos" else v[:, rows] for k, v in cache.items()}


def put_cache_rows(cache: Dict[str, torch.Tensor], rows,
                   sub: Dict[str, torch.Tensor]) -> None:
    """Write `sub` into rows `rows` of a contiguous cache, in place."""
    for k, v in cache.items():
        if k == "pos":
            v[rows] = sub[k]
        else:
            v[:, rows] = sub[k]


def check_ported(serve: ServeConfig) -> None:
    """Raise for ServeConfig features this slice has not ported yet."""
    for name, set_ in (("prefix_cache", serve.prefix_cache),
                       ("swap_space_blocks", serve.swap_space_blocks > 0),
                       ("mesh_shape", bool(serve.mesh_shape))):
        if set_:
            raise NotImplementedError(
                f"ServeConfig.{name} is not yet ported to repro_torch")


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
    n_decode: int = 0
    dispatched: bool = False
    #: set at dispatch: the tokens' pinned host copy, its staging arena,
    #: and (on the card) the event recorded behind the copy
    host: Optional[torch.Tensor] = None
    arena: int = -1
    event: Optional[torch.cuda.Event] = None


class Engine:
    def __init__(self, model: Model, params, serve: ServeConfig,
                 max_context: int = 256,
                 buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64),
                 prefill_chunk: int = 32, seed: int = 0,
                 temperature: float = 0.0, device=None,
                 cuda_graphs: Optional[bool] = None):
        """`cuda_graphs`: run each step as a CUDA graph replay (default on
        the card); False runs the same steps eagerly, as on the CPU, where
        True raises."""
        check_ported(serve)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
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
        eta = serve.kv_pool_tokens or self.max_slots * max_context
        self.mem = MemoryModel(self.cfg, hbm_budget_bytes=0,
                               eps_m=serve.eps_m,
                               block_size=serve.block_size, eta_tokens=eta)
        self.paged = serve.paged_kv
        self.blocks = BlockManager(self.mem.eta, serve.block_size)
        self.n_slots = self.max_slots + self.n_lanes
        # per-request block-table width: enough blocks for a full context
        self.max_blocks = -(-max_context // serve.block_size)
        # state-only family: constant per-request state, no K/V to grow
        self.state_only = self.mem.bytes_per_token == 0
        if self.paged:
            self.cache = model.init_paged_cache(
                self.mem.num_blocks, serve.block_size, n_slots=self.n_slots)
            self._free_slots = list(range(self.n_slots))
        else:
            self.cache = model.init_cache(self.n_slots, max_context,
                                          prefill_chunk=prefill_chunk)
        self.tel = Telemetry()
        self.policy = make_policy(serve, self.mem)
        self.graphs = StepGraphs(self.device, self.device.type == "cuda"
                                 if cuda_graphs is None else cuda_graphs)
        # async dispatch-ahead (DESIGN §14): up to overlap_depth dispatched
        # intervals stay un-retired while the host schedules the next
        self.overlap_depth = max(0, int(serve.overlap_depth))
        self._inflight: "collections.deque[_StepRec]" = collections.deque()
        self._staging = Staging(self.device, depth=self.overlap_depth)

        self.waiting: List[Request] = []
        self.active: List[Request] = []          # compact: slot i = active[i]
        # PD fusion (DESIGN §6): admitted requests being chunk-prefilled; a
        # request with r.lane >= 0 owns lane r.lane, the rest queue
        self.prefilling: List[Request] = []
        self.lanes: List[Optional[Request]] = [None] * self.n_lanes
        self.now0 = time.perf_counter()
        self._next_rid = 0
        self.total_decoded = 0
        self.total_finished = 0
        self.admitted_total = 0   # successful admissions from `waiting`
        self.preemptions = 0      # recompute evictions
        self.oom_events = 0       # admission refusals at the watermark
        self.rejected = 0         # requests too large for the pool, dropped
        # per-request goodput SLOs (DESIGN §15), stamped at retirement
        self.sla_requests_met = 0
        self.goodput_tokens = 0
        # contiguous-layout row copies (promotion/compaction/eviction);
        # stays 0 under paged_kv (DESIGN §9)
        self.copy_rows = 0
        self.copy_bytes = 0
        self._row_bytes = 0 if self.paged else sum(
            v[:, 0].numel() * v.element_size() if k != "pos"
            else v[0].numel() * v.element_size()
            for k, v in self.cache.items())
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

    def _free_request(self, r: Request) -> None:
        """Release a request's blocks; in paged mode clear their pos-pool
        rows so a future tenant never sees stale positions, and return its
        state slot (DESIGN §9)."""
        freed = self.blocks.free(r.rid)
        self._pending_tok.pop(r.rid, None)
        if not self.paged:
            return
        if freed and "pos" in self.cache:
            ids = torch.empty(len(freed), dtype=torch.int64,
                              device=self.device)
            self._staging.copy(ids, np.fromiter(freed, np.int64, len(freed)))
            self.cache["pos"][ids] = -1
        if r.slot >= 0:
            self._free_slots.append(r.slot)
            r.slot = -1

    # -- compiled steps (graphs.py) -----------------------------------------------
    def _step(self, key: Tuple) -> Step:
        """The step of shape key `key`, built (and on the card captured) at
        first use: ("decode", bucket) or ("chunk", rows, take, cache row),
        the cache row set only for a one-row contiguous chunk, which runs
        on a view of that row (-1 otherwise)."""
        st = self.graphs.steps.get(key)
        if st is None:
            st = self._build_step(key)
            if self.graphs.enabled:
                with self._state_kept(st):
                    self.graphs.capture(st)
            self.graphs.steps[key] = st
        return st

    def _build_step(self, key: Tuple) -> Step:
        """Static inputs holding an all-padding step (positions -1, empty
        tables, the sentinel state slot, or the lane rows of a contiguous
        multi-row chunk), which writes no visible slot, and the function
        that runs the model on them at fixed cache addresses."""
        decode = key[0] == "decode"
        rows, take = (key[1], 1) if decode else key[1:3]
        row = -1 if decode else key[3]
        dev = self.device
        inp = {"tokens": torch.zeros((rows, take), dtype=torch.int64,
                                     device=dev),
               "positions": torch.full((rows, take), -1, dtype=torch.int32,
                                       device=dev)}
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
                         tables=i["block_table"], rows=i["slots"])[0][:, -1]
        elif decode or row >= 0:
            start = 0 if decode else row
            kept = slice(start, start + rows)
            view = self._rows_view(start, rows)

            def fn(i):
                return m(p, i["tokens"], i["positions"], view, decode=decode,
                         last_only=not decode)[0][:, -1]
        else:
            # lane rows need not be adjacent: gather, run, scatter back
            kept = slice(self.max_slots, self.max_slots + rows)
            inp["slots"] = torch.arange(kept.start, kept.stop, device=dev)

            def fn(i):
                sub = cache_rows(self.cache, i["slots"])
                logits, sub = m(p, i["tokens"], i["positions"], sub,
                                last_only=True)
                put_cache_rows(self.cache, i["slots"], sub)
                return logits[:, -1]
        return Step(key, inp, fn, cache_rows=kept)

    @contextlib.contextmanager
    def _state_kept(self, st: Step):
        """Keep the per-request state of the contiguous rows `st` writes
        across the eager runs that precede its capture: an all-padding step
        writes no K/V or position, but the recurrent layers step every
        row's state."""
        rows = st.cache_rows
        kept = {} if rows is None else {
            k: self.cache[k][:, rows].clone() for k in STATE_KEYS
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
        """Build, and on the card capture, every decode bucket and every
        full-chunk lane shape ahead of time (the reference's
        `Engine.warmup`); tail chunks are captured at first use. The
        all-padding steps change no visible cache slot."""
        keys = [("decode", b) for b in self.buckets]
        C = self.prefill_chunk
        if self.paged:
            groups = range(1, self.n_lanes + 1) \
                if self.serve.chunked_prefill else (1,)
            keys += [("chunk", g, C, -1) for g in groups]
        elif self.serve.chunked_prefill:
            keys += [("chunk", 1, C, self.max_slots + j)
                     for j in range(self.n_lanes)]
            keys += [("chunk", g, C, -1) for g in range(2, self.n_lanes + 1)]
        else:
            keys += [("chunk", 1, C, r) for r in range(self.max_slots)]
        for key in keys:
            self._step(key)

    # -- public API -------------------------------------------------------------
    def submit(self, prompt_tokens: List[int], max_new_tokens: int = 0,
               arrival_time: Optional[float] = None) -> Request:
        t = arrival_time if arrival_time is not None else self._now()
        mx = max_new_tokens or self.serve.max_new_tokens
        mx = min(mx, self.max_context - len(prompt_tokens) - 1)
        r = Request(rid=self._next_rid, arrival_time=t,
                    prompt_tokens=list(prompt_tokens), max_new_tokens=mx)
        self._next_rid += 1
        self.waiting.append(r)
        self.tel.on_arrival(t, r.prompt_len)
        return r

    def _now(self) -> float:
        return time.perf_counter() - self.now0

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
        if not self.waiting and not self.active and not self.prefilling:
            # pipeline drain: retirement only patches values, timestamps
            # and telemetry, never schedulable work, so this call still
            # reports idle and run() counts the synchronous loop's steps
            while self._inflight:
                self._retire_step()
            return False
        t0 = time.perf_counter()
        tel = self.tel.snapshot(
            now=self._now(),
            n_prefill=len(self.waiting) + len(self.prefilling),
            n_decode=len(self.active), free_tokens=self.blocks.free_tokens,
            logical_used_tokens=self.blocks.logical_used_tokens,
            physical_used_tokens=self.blocks.physical_used_tokens)
        decision = self.policy.step(tel)
        # sim-mirrored admission (DESIGN §7): the controller's cap rounded
        # to the batch buckets, gated by the shared admission verdict
        cap = bucketize(decision.max_batch, self.serve.batch_buckets) \
            if self.serve.batch_buckets else decision.max_batch
        cap = min(cap, decision.max_batch, self.max_slots)
        rec = _StepRec()

        while self.waiting \
                and len(self.active) + len(self.prefilling) < cap:
            r = self.waiting[0]
            # a state-only request holds one block: an admission cap
            need = self.serve.block_size if self.state_only \
                else r.prompt_len + 1
            verdict = self.blocks.admission_verdict(
                self.blocks.blocks_needed(0, need, r.rid), self.max_blocks)
            if verdict != "admit":
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
            self.waiting.pop(0)
            self.admitted_total += 1
            if self.serve.chunked_prefill:
                r.state = RequestState.PREFILLING
                r.prefill_pos = 0
                self.prefilling.append(r)
            else:
                self._prefill_request(r, rec)

        self._preempt_if_needed()
        if self.serve.chunked_prefill:
            # PD fusion: one fused interval = prefill chunks (within the
            # controller's token budget) + the decode batch
            budget = decision.chunk_budget \
                or self.serve.chunk_budget_tokens
            if budget <= 0 and self.prefilling and not self.active:
                # nothing decoding and no token budget: make minimum
                # progress on one full chunk instead of livelocking
                budget = self.prefill_chunk
            self._advance_prefill(budget, rec)
        if self.active:
            self._decode_once(rec)
        if rec.dispatched:
            self._dispatch_readback(rec)
            self._inflight.append(rec)
        device_s = 0.0
        while len(self._inflight) > self.overlap_depth:
            device_s += self._retire_step()
        host_s = (time.perf_counter() - t0) - device_s
        self.step_host_trace.append(host_s)
        self.step_device_trace.append(device_s)
        self.tel.on_interval(host_s, device_s)
        return True

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

    def _prefill_group(self, reqs: List[Request], take: int) -> torch.Tensor:
        """One prefill chunk of `take` tokens for each request (same-size
        lane chunks batched into one step). Returns each row's greedy next
        token (len(reqs),) on the device: the step's logits are consumed
        here, before any other step runs (the graphs share one pool)."""
        g = len(reqs)
        row = reqs[0].slot if g == 1 and not self.paged else -1
        st = self._step(("chunk", g, take, row))
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
        return st.run().argmax(-1)

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
        groups: Dict[int, list] = {}
        for j, r, t in plan:
            groups.setdefault(t, []).append((j, r))
        first_tok: Dict[int, torch.Tensor] = {}   # lane -> next token
        for take, entries in groups.items():
            toks = self._prefill_group([r for _, r in entries], take)
            rec.dispatched = True
            rec.probe = toks
            for i, (j, _) in enumerate(entries):
                first_tok[j] = toks[i]

        rec.lane_tokens = {j: t for j, _, t in plan}
        for _, r, take in plan:
            r.prefill_pos += take
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
        exact-size chunks of `prefill_chunk` tokens."""
        if self.paged:
            self._acquire_slot(r)
        else:
            r.slot = len(self.active)
            self._clear_row(r.slot)
        r.state = RequestState.PREFILLING
        tok = None
        for start in range(0, r.prompt_len, self.prefill_chunk):
            r.prefill_pos = start
            take = min(self.prefill_chunk, r.prompt_len - start)
            tok = self._prefill_group([r], take)[0]
        r.prefill_pos = r.prompt_len
        r.state = RequestState.RUNNING
        # the synchronous path feeds no TTFT split (no chunked service)
        self._emit_first(r, tok, rec, feed=False)
        self.active.append(r)

    def _preempt_if_needed(self):
        """Recompute preemption: evict the newest request until the next
        decode step's block growth fits the pool (vLLM order). A state-only
        family's decode never grows, so it never preempts."""
        if self.state_only:
            return
        while self.active:
            need = sum(self.blocks.blocks_needed(r.context_len, 1, r.rid)
                       for r in self.active)
            if need <= self.blocks.free_blocks:
                return
            self._evict(len(self.active) - 1, self.active[-1])

    def _evict(self, slot: int, r: Request):
        """Evict active[slot] for recompute: paged mode releases blocks,
        contiguous mode compacts by moving the last row into the hole."""
        self._free_request(r)
        r.state = RequestState.WAITING
        # a new life: patches recorded against the cleared outputs drop
        self._gen[r.rid] = self._gen.get(r.rid, 0) + 1
        r.output_tokens.clear()
        r.tbt_samples.clear()
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
        n = len(self.active)
        ge = [b for b in self.buckets if b >= n]
        bucket = min(ge) if ge else self.max_slots
        st = self._step(("decode", bucket))
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
        self._stage(st, "tokens", toks)
        self._stage(st, "positions", lens)
        if pend:
            idx = torch.empty(len(pend), dtype=torch.int64,
                              device=self.device)
            self._staging.copy(idx, np.fromiter(pend, np.int64, len(pend)))
            st.inputs["tokens"].view(-1).index_copy_(0, idx, torch.stack(
                [self._pending_tok[self.active[i].rid] for i in pend]))
        if self.paged:
            self._stage(st, "block_table",
                        self._block_tables(self.active, bucket))
            # padding rows read the sentinel slot n_slots (zeros)
            slots = np.full(bucket, self.n_slots, np.int64)
            slots[:n] = [r.slot for r in self.active]
            self._stage(st, "slots", slots)
        logits = st.run()
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
            rec.event = torch.cuda.Event()
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
        if rec.event is not None:
            rec.event.synchronize()
        dev_s = time.perf_counter() - t0
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
        """The JAX engine's summary keys; those of features not ported
        (mesh shards, swap, prefix sharing) read their idle values."""
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
            "model_shards": 1.0,
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
            "swap_outs": 0,
            "swap_ins": 0,
            "swap_out_bytes": 0.0,
            "swap_in_bytes": 0.0,
            "swapped_peak": 0.0,
            "swap_latency_s_mean": 0.0,
            "copy_rows": float(self.copy_rows),
            "copy_bytes": float(self.copy_bytes),
            "prefix_hit_rate": 0.0,
            "prefix_hit_tokens": 0.0,
            "prefix_query_tokens": 0.0,
            "cached_blocks": 0.0,
            "cache_evictions": 0.0,
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
