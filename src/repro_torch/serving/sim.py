"""Discrete-event simulator of a continuous-batching serving engine.

The port's copy of the JAX package's `serving/sim.py`, over the port's own
config, controller, cost model, allocator and request modules: the same
inputs give the same `SimResult`, field for field.

Runs the SAME controller stack (Telemetry -> Policy -> BlockManager
admission, DESIGN §1) as the serving engine, replacing the model step with
the CostModel time law and pre-sampled output lengths (DESIGN §7). This is
how the paper's GPU-scale tables (LLaMA-65B/70B, PanGu-7/38/135B) are
reproduced on CPU; the scheduling code under test is identical, byte for
byte.

Step semantics mirror the engine exactly, interval for interval (the
differential harness in `tests/test_torch_differential.py` pins it):
  * non-fused mode: admission prefills each admitted request immediately
    (its first token comes from the prefill's final logits), then one
    decode iteration over the running batch.
  * PD-fusion mode (chunked prefill, DESIGN §6): each step packs
    `chunk_budget` prefill tokens across up to `n_prefill_lanes` concurrent
    prefills (the engine's lane semantics: sticky lanes, fifo/srf packer,
    optional per-lane chunk cap); finished lanes promote BEFORE the decode
    batch forms, so a promoted request decodes in its promotion interval.
  * preemption (DESIGN §11): newest victim first; per victim the cost-model
    crossover picks host-offload swap (blocks to the swap ledger, restored
    by the swapped-queue drain ahead of admission) vs recompute (KV
    discarded; the emitted count resets because the engine regenerates the
    victim's output from scratch).
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import random
from typing import Dict, List, Optional

from repro_torch.config.base import ModelConfig, ServeConfig
from repro_torch.core.batching import (BatchDecision, Policy, bucketize,
                                      make_policy)
from repro_torch.core.lanes import lane_order, pack_chunks
from repro_torch.core.memory_model import MemoryModel, kv_shard_factor
from repro_torch.core.telemetry import Telemetry
from repro_torch.serving.cost_model import CostModel
from repro_torch.serving.kv_cache import (BlockManager,
                                          prefix_cache_supported,
                                          swap_supported)
from repro_torch.serving.request import Request, RequestState


@dataclasses.dataclass
class LengthDist:
    """Request length sampler: lognormal-ish around the paper's workload
    means (paper §IV experimental setup; DESIGN §7)."""
    mean_in: float
    mean_out: float
    cv_in: float = 0.3          # coefficient of variation
    cv_out: float = 0.5
    fixed: bool = False         # PanGu rows: exactly 128/128

    def sample(self, rng: random.Random):
        if self.fixed:
            return int(self.mean_in), int(self.mean_out)
        li = max(1, int(rng.lognormvariate(*_lognorm(self.mean_in, self.cv_in))))
        lo = max(1, int(rng.lognormvariate(*_lognorm(self.mean_out, self.cv_out))))
        return li, lo


def _lognorm(mean: float, cv: float):
    import math
    sigma2 = math.log(1 + cv * cv)
    mu = math.log(mean) - sigma2 / 2
    return mu, math.sqrt(sigma2)


@dataclasses.dataclass
class SimResult:
    """Aggregate run metrics (the paper's Table I/II columns; DESIGN §7)."""
    total_tokens: int = 0
    duration_s: float = 0.0
    finished: int = 0
    admitted: int = 0               # successful admissions from `waiting`
    preemptions: int = 0            # evictions, recompute + swap-out alike
    oom_events: int = 0
    rejected: int = 0               # requests too large for the pool, dropped
    # two-tier swap (DESIGN §11)
    swap_outs: int = 0
    swap_ins: int = 0
    swap_out_bytes: int = 0
    swap_in_bytes: int = 0
    swapped_peak: int = 0           # peak concurrently offloaded requests
    swap_latency_s_mean: float = 0.0
    tbt_ms_mean: float = 0.0
    tbt_ms_p95: float = 0.0
    # prefix sharing (DESIGN §10): admission-time shared-prefix telemetry
    prefix_hit_tokens: int = 0
    prefix_query_tokens: int = 0
    prefix_hit_rate: float = 0.0
    cache_evictions: int = 0
    ttft_p90_s: float = 0.0         # time-to-first-token (queueing + prefill)
    ttft_mean_s: float = 0.0
    # TTFT attribution (DESIGN §6): queue wait vs prefill service means
    # (engine-summary key names — the differential harness compares by name)
    ttft_queue_s_mean: float = 0.0
    ttft_prefill_s_mean: float = 0.0
    prefill_lane_occupancy: float = 0.0  # mean busy-lane fraction, fused steps
    prefill_tokens: float = 0.0     # total prefill tokens packed (DESIGN §6)
    sla_attainment: float = 0.0     # fraction of decode steps within SLA
    # per-request goodput SLOs (DESIGN §15): requests meeting BOTH the
    # TTFT and mean-TBT SLAs, their token volume, and the attainment
    # fraction over finished + rejected (dropping a request counts
    # against attainment — rejection can never inflate it)
    sla_requests_met: int = 0
    goodput_tokens: int = 0
    request_sla_attainment: float = 0.0
    mean_batch: float = 0.0
    decode_steps: int = 0
    # host-vs-device interval split (DESIGN §14): the cost model's
    # host_overhead_ms share of each interval vs the device remainder
    step_host_s_mean: float = 0.0
    step_device_s_mean: float = 0.0
    # mesh-sharded pool (DESIGN §12) + end-of-run pool occupancy (§9/§10)
    model_shards: float = 1.0
    pool_tokens: float = 0.0
    cached_blocks: float = 0.0
    logical_used_tokens: float = 0.0
    physical_used_tokens: float = 0.0
    logical_used_bytes: float = 0.0
    physical_used_bytes: float = 0.0
    batch_trace: List[int] = dataclasses.field(default_factory=list)
    decisions: List[BatchDecision] = dataclasses.field(default_factory=list)

    @property
    def throughput_tok_s(self) -> float:
        return self.total_tokens / max(self.duration_s, 1e-9)

    @property
    def goodput_tok_s(self) -> float:
        """Throughput counting only SLA-met requests' tokens (DESIGN §15)."""
        return self.goodput_tokens / max(self.duration_s, 1e-9)


class ServingSimulator:
    """Discrete-event twin of `serving.engine.Engine` (DESIGN §7).

    `prefill_chunk` mirrors the engine's per-lane chunk cap in PD-fusion
    mode (0 = uncapped: a lane may take its whole remaining prompt within
    the interval budget)."""

    def __init__(self, cfg: ModelConfig, serve: ServeConfig, cost: CostModel,
                 lengths: LengthDist, seed: int = 0,
                 policy: Optional[Policy] = None, prefill_chunk: int = 0,
                 max_context: int = 0):
        self.cfg = cfg
        self.serve = serve
        self.cost = cost
        self.lengths = lengths
        self.rng = random.Random(seed)
        self.prefill_chunk = prefill_chunk
        # engine-mirrored per-request block-table width (DESIGN §9): with a
        # max_context the sim rejects prompts wider than the table exactly
        # like the engine; 0 = unbounded (the sim has no physical table)
        self.max_context = max_context
        self.max_blocks = -(-max_context // serve.block_size) \
            if max_context else 0
        self.n_lanes = max(1, serve.n_prefill_lanes)
        # PD-fusion lanes (DESIGN §6): sticky request-per-lane, same
        # semantics as the engine's spare physical rows
        self.lanes: List[Optional[Request]] = [None] * self.n_lanes

        # mesh-sharded serving (DESIGN §12): mirror the engine's chip-aware
        # pool — serve budgets are per-chip under a mesh and the effective
        # model-axis shard count scales the token capacity. The cost
        # model's derived budget already aggregates every chip, so it is
        # brought back to per-chip before MemoryModel re-scales it.
        self.model_shards = kv_shard_factor(cfg, serve.model_axis_size)
        pool_bytes = serve.hbm_budget_bytes \
            or cost.kv_pool_bytes() // self.model_shards
        self.mem = MemoryModel(cfg, pool_bytes, eps_m=serve.eps_m,
                               block_size=serve.block_size,
                               eta_tokens=serve.kv_pool_tokens,
                               model_shards=self.model_shards)
        eta = self.mem.eta
        if eta == 0:  # attention-free: cap by request state instead
            eta = self.mem.max_requests_state_only() * serve.block_size
        # prefix sharing (DESIGN §10): same family gate as the engine so
        # sim and engine hit rates stay comparable; the sim needs request
        # token content (feed_tokens / shared-prefix workloads) to match
        self.prefix = (serve.prefix_cache and prefix_cache_supported(cfg)
                       and self.mem.bytes_per_token != 0)
        # two-tier swap (DESIGN §11): the engine's exact gate — the engine
        # needs the paged pool to move physical blocks, so the sim honors
        # paged_kv too to keep the twins' behavior identical
        self.swap = (serve.swap_space_blocks > 0
                     and serve.preempt != "recompute" and serve.paged_kv
                     and swap_supported(cfg)
                     and self.mem.bytes_per_token != 0)
        self.blocks = BlockManager(eta, serve.block_size,
                                   prefix_cache=self.prefix,
                                   swap_space_blocks=serve.swap_space_blocks
                                   if self.swap else 0)
        self.tel = Telemetry(prior_mean_in=lengths.mean_in,
                             prior_mean_out=lengths.mean_out)
        self.policy = policy or make_policy(serve, self.mem)

        self.waiting: List[Request] = []
        self.running: List[Request] = []
        # fused-mode prefill backlog (admitted, chunk-prefilling; engine's
        # `prefilling` list)
        self.pending_prefill: List[Request] = []
        # offloaded requests awaiting swap-in (DESIGN §11); admission
        # drains this queue before `waiting`, exactly like the engine
        self.swapped: List[Request] = []
        self._all: List[Request] = []
        self.now = 0.0
        self.res = SimResult()
        self._tbts: List[float] = []
        self._swap_waits: List[float] = []
        self._sla_ok = 0
        self._sla_steps = 0
        # async dispatch-ahead mirror (DESIGN §14): telemetry feeds lag
        # behind scheduling by up to overlap_depth dispatched intervals,
        # exactly like the engine's retirement pipeline; the clock charges
        # max(host, device) per interval instead of host + device
        self.overlap_depth = max(0, int(serve.overlap_depth))
        self._feed_lag: "collections.deque[list]" = collections.deque()
        self._feeds: list = []      # current interval's deferred feeds
        self._host_s: List[float] = []
        self._dev_s: List[float] = []

    # -- workload -------------------------------------------------------------
    def add_requests(self, n: int, arrival_rate: float = 0.0):
        """arrival_rate == 0 => infinite backlog (all at t=0, paper Table I).

        Safe to call repeatedly (and to mix with workload.feed/_tokens/
        _trace): rids offset past the existing population, `_all` grows by
        only the new requests."""
        base = len(self._all)
        t = 0.0
        new = []
        for i in range(n):
            li, lo = self.lengths.sample(self.rng)
            new.append(Request(
                rid=base + i, arrival_time=t, prompt_len=li,
                true_output_len=lo,
                max_new_tokens=self.serve.max_new_tokens))
            if arrival_rate > 0:
                t += self.rng.expovariate(arrival_rate)
        self.waiting.extend(new)
        self.waiting.sort(key=lambda r: r.arrival_time)
        self._all.extend(new)

    # -- scheduling interval ----------------------------------------------------
    def _snapshot(self):
        arrived = [r for r in self.waiting if r.arrival_time <= self.now]
        # engine-mirrored N^p: un-admitted arrivals + the fused prefill
        # backlog (engine counts waiting + prefilling)
        return self.tel.snapshot(
            now=self.now,
            n_prefill=len(arrived) + len(self.pending_prefill),
            n_decode=len(self.running),
            free_tokens=self.blocks.free_tokens,
            logical_used_tokens=self.blocks.logical_used_tokens,
            physical_used_tokens=self.blocks.physical_used_tokens,
            swapped_tokens=self.blocks.swapped_tokens)

    def _admit(self, decision: BatchDecision):
        """Admission control: fill up to max_batch respecting the block pool."""
        # engine-mirrored floor-bucket guard: rounding UP to the smallest
        # compiled bucket must not admit past the controller's decision
        cap = bucketize(decision.max_batch, self.serve.batch_buckets) \
            if self.serve.batch_buckets else decision.max_batch
        cap = min(cap, decision.max_batch)
        # swap-in drain (DESIGN §11, engine-mirrored): offloaded requests
        # re-enter before any new admission, and while any remain the
        # waiting queue is held back
        while self.swapped \
                and len(self.running) + len(self.pending_prefill) < cap:
            if not self._swap_in_next():
                self.res.oom_events += 1
                break
        admitted = []
        if self.swapped:
            return admitted
        for r in list(self.waiting):
            # engine-mirrored cap: running + prefill backlog + this batch
            if len(self.running) + len(self.pending_prefill) \
                    + len(admitted) >= cap:
                break
            if r.arrival_time > self.now:
                break
            need = r.context_len + 1  # context covers recompute re-prefill
            if self.mem.bytes_per_token == 0:
                need = self.serve.block_size  # state-only families
            # prefix sharing (DESIGN §10): engine-mirrored — map shared
            # full prompt blocks first, gate on the suffix, roll back on
            # refusal so hit rates stay engine-comparable
            cached = 0
            if self.prefix and r.prompt_tokens:
                cached = self.blocks.acquire_prefix(r.rid, r.prompt_tokens)
            have = len(self.blocks.block_tables.get(r.rid, ()))
            nb = self.blocks.blocks_needed(0, need, r.rid)
            mb = self.max_blocks - have if self.max_blocks else 0
            # shared engine/sim gate (DESIGN §7): vLLM 1% watermark +
            # unservable rejection live in BlockManager.admission_verdict
            verdict = "reject" if self.max_blocks and mb <= 0 and nb > 0 \
                else self.blocks.admission_verdict(nb, mb)
            if verdict != "admit":
                if cached:
                    self.blocks.free(r.rid)
                if verdict == "reject":
                    self.waiting.remove(r)
                    r.state = RequestState.FINISHED
                    r.rejected = True
                    # goodput verdict (DESIGN §15): a dropped request
                    # counts against attainment, never for it
                    r.stamp_sla(self.serve.ttft_sla_s,
                                self.serve.tbt_sla_ms)
                    self.res.rejected += 1
                    continue
                self.res.oom_events += 1
                break
            self.blocks.allocate(r.rid, 0, need)
            if self.prefix:
                self.blocks.note_prefix_query(r.prompt_len, cached)
            r.cached_prefix_len = cached
            self.res.admitted += 1
            admitted.append(r)
        for r in admitted:
            self.waiting.remove(r)
            r.state = RequestState.PREFILLING
            r.prefill_pos = r.cached_prefix_len
        return admitted

    def _preempt_if_needed(self):
        """On pool exhaustion mid-decode, evict newest requests; per victim
        the DESIGN §11 crossover picks host-offload swap vs recompute."""
        if self.mem.bytes_per_token == 0:
            return  # constant per-request state: decode never grows it
        while self.running:
            need = sum(self.blocks.blocks_needed(r.context_len, 1, r.rid)
                       for r in self.running)
            if need <= self.blocks.free_blocks:
                return
            victim = self.running[-1]  # newest first in BOTH modes (vLLM)
            if self._should_swap(victim):
                self._swap_out(victim)
            else:
                self._recompute_evict(victim)

    def _recompute_evict(self, victim: Request):
        """Recompute preemption: discard the victim's KV; it re-prefills
        its prompt from scratch and regenerates its output (the engine
        clears `output_tokens`; greedy decoding makes the regenerated
        tokens identical)."""
        self.running.remove(victim)
        self.blocks.free(victim.rid)
        victim.state = RequestState.WAITING
        victim.prefill_pos = 0
        # recompute re-probes the prefix index at re-admission (§10)
        victim.cached_prefix_len = 0
        # engine-mirrored: re-attribute TTFT on the recompute pass
        victim.prefill_start_time = -1.0
        victim.sim_reset_output()
        self.waiting.insert(0, victim)
        self.res.preemptions += 1

    def _should_swap(self, r: Request) -> bool:
        """Engine-mirrored per-victim choice (DESIGN §11): host space +
        no shared blocks + re-admittable, then the cost-model crossover
        (preempt="swap" forces swap whenever possible)."""
        if not self.swap \
                or not self.blocks.can_swap_out(r.rid, self.max_blocks):
            return False
        if self.serve.preempt == "swap":
            return True
        return self.cost.swap_beats_recompute(
            len(self.blocks.block_tables[r.rid]), self.serve.block_size,
            r.context_len)

    def _swap_out(self, r: Request):
        """Offload the victim to the host pool: the PCIe transfer time
        lands on the sim clock, the blocks move to the swap ledger."""
        nb = len(self.blocks.block_tables[r.rid])
        self.blocks.swap_out(r.rid)
        self.now += self.cost.pcie_s(nb, self.serve.block_size)
        self.res.swap_outs += 1
        self.res.preemptions += 1
        self.res.swap_out_bytes += self.mem.blocks_to_bytes(nb)
        r.state = RequestState.SWAPPED
        r.swap_out_time = self.now
        self.running.remove(r)
        self.swapped.append(r)

    def _swap_in_next(self) -> bool:
        """Restore the oldest swapped request (FIFO), gated by the same
        watermark verdict as admission; False when the pool can't take it."""
        r = self.swapped[0]
        nb = len(self.blocks.swapped_block_tables[r.rid])
        if self.blocks.admission_verdict(nb, self.max_blocks) != "admit":
            return False
        self.blocks.swap_in(r.rid)
        self.now += self.cost.pcie_s(nb, self.serve.block_size)
        self.res.swap_ins += 1
        self.res.swap_in_bytes += self.mem.blocks_to_bytes(nb)
        if r.swap_out_time >= 0:
            wait = self.now - r.swap_out_time
            r.swapped_s += wait
            r.n_swaps += 1
            r.swap_out_time = -1.0
            self._swap_waits.append(wait)
        r.state = RequestState.RUNNING
        self.swapped.pop(0)
        self.running.append(r)
        return True

    # -- async dispatch-ahead mirror (DESIGN §14) ------------------------------
    def _tel_feed(self, fn, *args):
        """Park a telemetry feed behind the interval's retirement: the
        engine applies an interval's TBT/TTFT/throughput/completion feeds
        only when its device step retires, up to overlap_depth intervals
        later — the sim mirrors the same staleness so the twins' policies
        read identical snapshots. Args are evaluated NOW (dispatch-time
        values), only the application is deferred."""
        self._feeds.append((fn, args))

    def _retire_feeds(self, dispatched: bool):
        """End-of-interval retirement mirror: queue the interval's feed
        list iff it dispatched device work (the engine only pushes a
        retirement record then), and retire down to the pipeline depth.
        Depth 0 flushes the interval's own feeds before the next snapshot
        — byte-identical to the synchronous loop."""
        if dispatched:
            self._feed_lag.append(self._feeds)
            self._feeds = []
        while len(self._feed_lag) > self.overlap_depth:
            for fn, args in self._feed_lag.popleft():
                fn(*args)

    def _advance_clock(self, dt: float):
        """Advance the sim clock by one interval's tau. Under overlap the
        host share (admission, lane packing, block-table edits) runs
        concurrently with the in-flight device step, so the interval
        costs max(host, device) instead of host + device — the pipeline's
        whole throughput win (DESIGN §14)."""
        host, dev = self.cost.split_host_device(dt)
        self._host_s.append(host)
        self._dev_s.append(dev)
        self.now += max(host, dev) if self.overlap_depth else dt

    # -- steps -------------------------------------------------------------------
    def _prefill_step(self, reqs: List[Request]):
        # context_len covers recompute-after-preemption (prompt + kept
        # output); a shared prefix is already resident, so only suffix
        # tokens are charged to the prefill cost — attention still reads
        # the full context (DESIGN §10)
        toks = sum(r.context_len - r.cached_prefix_len for r in reqs)
        ctx = sum(r.context_len for r in reqs) / max(len(reqs), 1)
        for r in reqs:
            if r.prefill_start_time < 0:
                r.prefill_start_time = self.now
        dt = self.cost.tau_step_s(0, 0.0, prefill_tokens=toks, prefill_ctx=ctx)
        self._advance_clock(dt)
        for r in reqs:
            r.state = RequestState.RUNNING
            r.first_token_time = self.now
            if self.prefix and r.prompt_tokens:
                self.blocks.commit_prefill(r.rid, r.prompt_tokens,
                                           r.prompt_len)
            self._tel_feed(self.tel.on_first_token,
                           r.prefill_start_time - r.arrival_time,
                           self.now - r.prefill_start_time)
            # the engine samples the first output token from the prefill's
            # final logits — mirror the emission so step counts line up
            r.sim_emit_token()
            self.running.append(r)

    # -- PD-fusion lane packer (shared with the engine, DESIGN §6) -------------
    def _fill_lanes(self, pending: List[Request]):
        queued = [(None, r) for r in pending if r.lane < 0]
        if not queued:
            return
        queued = lane_order(self.serve.prefill_pack, queued)
        for j in range(self.n_lanes):
            if self.lanes[j] is not None:
                continue
            if not queued:
                break
            _, r = queued.pop(0)
            r.lane = j
            self.lanes[j] = r

    def _decode_step(self, fused_prefill: List[Request], chunk_budget: int):
        pf_tokens = 0
        promoted: List[Request] = []
        # zero budget skips lane filling too (the engine's _advance_prefill
        # returns before assigning lanes) so lane assignment order cannot
        # drift between the twins across zero-budget intervals
        if fused_prefill and chunk_budget > 0:
            self._fill_lanes(fused_prefill)
            plan = pack_chunks(self.serve.prefill_pack, self.lanes,
                               chunk_budget, self.prefill_chunk)
            lane_tokens: Dict[int, int] = {}
            for j, r, take in plan:
                if r.prefill_start_time < 0:
                    r.prefill_start_time = self.now
                r.prefill_pos += take
                if self.prefix and r.prompt_tokens:
                    self.blocks.commit_prefill(r.rid, r.prompt_tokens,
                                               r.prefill_pos)
                lane_tokens[j] = take
            pf_tokens = sum(lane_tokens.values())
            if lane_tokens:
                self._tel_feed(self.tel.on_prefill_interval, lane_tokens,
                               self.n_lanes)
            # finished lanes promote BEFORE the decode batch forms
            # (lane-index order: deterministic, matches the engine) — a
            # promoted request decodes in its promotion interval
            for j in range(self.n_lanes):
                r = self.lanes[j]
                if r is None or r.prefill_pos < r.prompt_len:
                    continue
                self.lanes[j] = None
                r.lane = -1
                r.state = RequestState.RUNNING
                promoted.append(r)
                self.running.append(r)
                fused_prefill.remove(r)
        b = len(self.running)
        mean_ctx = sum(r.context_len for r in self.running) / max(b, 1)
        dt = self.cost.tau_step_s(b, mean_ctx, prefill_tokens=pf_tokens,
                                  prefill_ctx=mean_ctx)
        self._advance_clock(dt)
        tbt_ms = dt * 1e3
        # a promoted request's first token comes from the final prefill
        # chunk's logits (the engine appends it at promotion), then it
        # joins the decode emission below — two tokens in the promotion
        # interval, exactly like the engine
        for r in promoted:
            r.first_token_time = self.now
            self._tel_feed(self.tel.on_first_token,
                           r.prefill_start_time - r.arrival_time,
                           self.now - r.prefill_start_time)
            r.sim_emit_token()
        if b:
            self._tel_feed(self.tel.on_decode_step, tbt_ms, b)
            self._tbts.append(tbt_ms)
            self.res.decode_steps += 1
            self._sla_steps += 1
            if self.serve.d_sla_ms <= 0 or tbt_ms <= self.serve.d_sla_ms \
                    + self.serve.eps_d_ms:
                self._sla_ok += 1
        # token emission + growth + completion, engine-mirrored: grow the
        # KV for the NEXT step's write, emit, finish-check; finished
        # requests free in reverse order; failed grows preempt (recompute)
        # after finish processing instead of silently drifting. State-only
        # families (bytes_per_token == 0) hold constant per-request state —
        # growing them would drain free_tokens linearly (phantom usage).
        self.res.total_tokens += b
        finished: List[Request] = []
        grow_failed: List[Request] = []
        for r in self.running:
            grew = True
            if self.mem.bytes_per_token != 0:
                grew = self.blocks.allocate(r.rid, r.context_len, 1)
            r.sim_emit_token()
            if r.done or (self.max_context
                          and r.context_len >= self.max_context - 1):
                finished.append(r)
            elif not grew:
                grow_failed.append(r)
        for r in reversed(finished):
            r.state = RequestState.FINISHED
            r.finish_time = self.now
            # goodput verdict (DESIGN §15): the sim's mirror of the
            # engine's retirement stamping — timestamps are final here
            if r.stamp_sla(self.serve.ttft_sla_s, self.serve.tbt_sla_ms):
                self.res.sla_requests_met += 1
                self.res.goodput_tokens += r.output_len
            self._tel_feed(self.tel.on_completion, r.output_len)
            self.blocks.free(r.rid)
            self.running.remove(r)
            self.res.finished += 1
        for r in grow_failed:
            if r in self.running:
                self._recompute_evict(r)
        self.res.batch_trace.append(b)
        # the engine only queues a retirement record when a graph was
        # dispatched — mirror that so the feed pipeline's cadence matches
        return pf_tokens > 0 or b > 0

    # -- main loop -----------------------------------------------------------------
    def run(self, max_steps: int = 200_000) -> SimResult:
        for r in self.waiting:
            self.tel.on_arrival(r.arrival_time, r.prompt_len)
        pending_prefill = self.pending_prefill
        steps = 0
        while (self.waiting or self.running or pending_prefill
               or self.swapped) and steps < max_steps:
            steps += 1
            # idle-advance to next arrival if nothing to do
            if not self.running and not pending_prefill \
                    and not self.swapped and self.waiting \
                    and self.waiting[0].arrival_time > self.now:
                self.now = self.waiting[0].arrival_time
            tel = self._snapshot()
            decision = self.policy.step(tel)
            self.res.decisions.append(decision)
            admitted = self._admit(decision)
            if self.serve.chunked_prefill:
                pending_prefill.extend(admitted)
                self._preempt_if_needed()
                budget = decision.chunk_budget \
                    or self.serve.chunk_budget_tokens
                if budget <= 0 and pending_prefill and not self.running:
                    # engine-mirrored livelock guard: no decodes and no
                    # budget would spin no-op steps forever
                    budget = self.prefill_chunk \
                        or pending_prefill[0].prompt_len
                dispatched = self._decode_step(pending_prefill, budget)
            else:
                # engine order: admitted requests prefill immediately
                # (inside the engine's admission loop), THEN the pool
                # pressure check runs — just-prefilled requests are
                # preemption candidates like any other
                dispatched = bool(admitted)
                if admitted:
                    self._prefill_step(admitted)
                self._preempt_if_needed()
                if self.running:
                    dispatched = self._decode_step([], 0) or dispatched
            # no physical pos rows to clear in the sim — drain the
            # eviction queue so it cannot grow for the run's lifetime
            self.blocks.take_released()
            self._retire_feeds(dispatched)
        # pipeline drain, engine-mirrored: the engine's final idle step()
        # retires every in-flight interval before reporting idle
        while self._feed_lag:
            for fn, args in self._feed_lag.popleft():
                fn(*args)
        self.res.duration_s = self.now
        ttfts = sorted(r.first_token_time - r.arrival_time
                       for r in self._all if r.first_token_time >= 0)
        if ttfts:
            self.res.ttft_p90_s = ttfts[int(0.9 * (len(ttfts) - 1))]
            self.res.ttft_mean_s = sum(ttfts) / len(ttfts)
        served = [r for r in self._all
                  if r.first_token_time >= 0 and r.prefill_start_time >= 0]
        if served:
            self.res.ttft_queue_s_mean = sum(
                r.prefill_start_time - r.arrival_time for r in served) \
                / len(served)
            self.res.ttft_prefill_s_mean = sum(
                r.first_token_time - r.prefill_start_time for r in served) \
                / len(served)
        if self.tel.lane_occ:
            self.res.prefill_lane_occupancy = \
                sum(self.tel.lane_occ) / len(self.tel.lane_occ)
        if self._tbts:
            s = sorted(self._tbts)
            self.res.tbt_ms_mean = sum(s) / len(s)
            self.res.tbt_ms_p95 = s[int(0.95 * (len(s) - 1))]
        if self._sla_steps:
            self.res.sla_attainment = self._sla_ok / self._sla_steps
        self.res.request_sla_attainment = self.res.sla_requests_met \
            / max(self.res.finished + self.res.rejected, 1)
        if self._host_s:
            self.res.step_host_s_mean = sum(self._host_s) / len(self._host_s)
            self.res.step_device_s_mean = sum(self._dev_s) / len(self._dev_s)
        if self.res.batch_trace:
            self.res.mean_batch = sum(self.res.batch_trace) / len(self.res.batch_trace)
        self.res.prefix_hit_tokens = self.blocks.prefix_hit_tokens
        self.res.prefix_query_tokens = self.blocks.prefix_query_tokens
        self.res.prefix_hit_rate = self.blocks.prefix_hit_rate
        self.res.cache_evictions = self.blocks.cache_evictions
        self.res.swapped_peak = self.blocks.swapped_peak
        if self._swap_waits:
            self.res.swap_latency_s_mean = \
                sum(self._swap_waits) / len(self._swap_waits)
        # engine-summary twins (counter-parity): shard/pool geometry,
        # prefill volume and end-of-run pool occupancy
        self.res.model_shards = float(self.model_shards)
        self.res.pool_tokens = float(self.mem.eta)
        self.res.prefill_tokens = float(self.tel.prefill_tokens_total)
        self.res.cached_blocks = float(self.blocks.cached_blocks)
        self.res.logical_used_tokens = float(self.blocks.logical_used_tokens)
        self.res.physical_used_tokens = float(self.blocks.physical_used_tokens)
        self.res.logical_used_bytes = float(self.mem.tokens_to_bytes(
            self.blocks.logical_used_tokens))
        self.res.physical_used_bytes = float(self.mem.tokens_to_bytes(
            self.blocks.physical_used_tokens))
        return self.res
