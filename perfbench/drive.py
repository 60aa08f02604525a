"""Builds the port's serving engine for a cell and drives it as its users
would: requests submitted when they fall due, `Engine.step()` called in a
loop, and every token stamped when the caller can first read it.

The engine is `repro_torch.serving.engine.Engine`, built by
`repro_torch.launch.serve.build_engine` from the cell's flags (through
`build_parser`), but on the weights the benchmark made from the seed.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch

from perfbench import record, traffic

_NULL = contextlib.nullcontext()


def engine_args(cell: Dict, seed: int, device: str):
    from repro_torch.launch.serve import build_parser

    return build_parser().parse_args(
        [str(a) for a in cell["serve"]] + ["--seed", str(seed),
                                           "--device", device])


def build_engine(cfg, args, weights, dtype):
    """`launch.serve.build_engine`'s engine for the cell's flags, on
    `weights` in place of the model's own random ones (`Model.init` answers
    with them during the call), its step graphs captured on the card:
    every decode bucket and every chunk shape a lane can take."""
    from unittest import mock

    from repro_torch.launch.serve import build_engine as serve_engine
    from repro_torch.models.model import Model

    with mock.patch.object(Model, "init", lambda self, seed=0: weights):
        eng = serve_engine(args, cfg=cfg, dtype=dtype)
    if eng.graphs.enabled:
        capture_tails(eng)
    return eng


def capture_tails(eng) -> None:
    """Capture the chunk shapes `Engine.warmup` leaves to first use (a
    lane's chunk shorter than the prefill chunk, alone or with others of
    its size), so that nothing is captured inside the measured window."""
    step = getattr(eng, "_step", None)
    if step is None:
        return
    C = eng.prefill_chunk
    if eng.paged:
        groups = range(1, eng.n_lanes + 1) if eng.serve.chunked_prefill \
            else (1,)
        keys = [("chunk", g, t, -1) for g in groups for t in range(1, C)]
    elif eng.serve.chunked_prefill:
        keys = [("chunk", 1, t, eng.max_slots + j) for t in range(1, C)
                for j in range(eng.n_lanes)]
        keys += [("chunk", g, t, -1) for g in range(2, eng.n_lanes + 1)
                 for t in range(1, C)]
    else:
        keys = [("chunk", 1, t, r) for t in range(1, C)
                for r in range(eng.max_slots)]
    for k in keys:
        step(k)


def counters(eng) -> Dict[str, float]:
    """The engine's counters the metrics read as deltas over the window."""
    b = eng.blocks
    return {"captures": float(eng.graphs.captures),
            "prefix_hit_tokens": float(b.prefix_hit_tokens),
            "prefix_query_tokens": float(b.prefix_query_tokens)}


class _Live:
    """The harness's view of one submitted request."""
    __slots__ = ("rec", "r", "seen", "pos", "first", "done")

    def __init__(self, rec: record.Req, r):
        self.rec, self.r = rec, r
        self.seen = 0          # tokens visible so far
        self.pos = None        # prefill position seen (None: not admitted)
        self.first = True      # its next chunk is its first
        self.done = False      # prompt fully prefilled


class Tracer:
    """Ranges for the profiler around what the host does, and the
    profiler itself over the window's last `start` onwards (it stops once
    the window has closed)."""

    def __init__(self, start: float, cuda: bool = True):
        self.start = start
        self.cuda = cuda
        self.prof = None
        self.on = False
        self.done = False

    def range(self, name: str):
        return torch.profiler.record_function(name) if self.on else _NULL

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def begin(self):
        """Start the profiler on an idle device, so that the slice holds
        the whole of every step dispatched in it."""
        self._sync()
        act = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            act.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=act)
        self.prof.__enter__()
        self.on = True

    def end(self):
        with self.range("perfbench.sync"):
            self._sync()
        self.prof.__exit__(None, None, None)
        self.on = False
        self.done = True


def prefill_setup(eng, plan: traffic.Plan) -> None:
    """Set-up's requests: each document once, one new token, so that its
    full blocks are indexed; served until the engine is idle."""
    for doc in plan.documents:
        eng.submit(doc, max_new_tokens=1)
    while eng.step():
        pass


class Driver:
    """Runs the warm phase and the window of one plan on one engine."""

    def __init__(self, eng, plan: traffic.Plan, seconds: float,
                 warm_seconds: float, tracer: Optional[Tracer] = None,
                 on_step: Optional[Callable] = None):
        self.eng, self.plan = eng, plan
        self.seconds, self.warm = seconds, warm_seconds
        self.tracer = tracer
        self.on_step = on_step
        self.reqs: List[record.Req] = []
        self.steps: List[record.Step] = []
        self.live: List[_Live] = []
        self.engine_reqs: Dict[int, object] = {}   # Req.index -> Request

    # -- submission ------------------------------------------------------
    def _submit(self, p: traffic.Planned, due: float, now: float) -> None:
        prompt = self.plan.prompt(p)
        r = self.eng.submit(prompt, max_new_tokens=p.max_new)
        rec = record.Req(index=len(self.reqs), warm=p.warm or due < 0,
                         due=due, submitted=now, prompt_len=len(prompt),
                         max_new=r.max_new_tokens, doc=p.doc)
        self.reqs.append(rec)
        self.engine_reqs[rec.index] = r
        self.live.append(_Live(rec, r))

    # -- bookkeeping after a step -----------------------------------------
    def _account(self, t: float, n_batch: int, traced: bool) -> List[_Live]:
        """Stamp the tokens made visible by the step that returned at `t`,
        count the work it dispatched, and return the requests it
        completed (all tokens visible, or rejected)."""
        from repro_torch.serving.request import RequestState

        eng = self.eng
        st = record.Step(t=t, traced=traced)
        takes = set()
        done, keep = [], []
        for lv in self.live:
            r, rec = lv.r, lv.rec
            out = r.output_tokens
            if r.rejected:
                rec.rejected = True
                done.append(lv)
                continue
            # prefill progress since the last step
            if not lv.done and r.state != RequestState.WAITING:
                if lv.pos is None or r.prefill_pos < lv.pos:
                    # admitted (again, after a recompute preemption)
                    lv.pos, lv.first = r.cached_prefix_len, True
                new = r.prompt_len if r.state in (
                    RequestState.RUNNING, RequestState.FINISHED) \
                    else r.prefill_pos
                if new > lv.pos:
                    a = lv.pos
                    n = new - a
                    st.prefill_tokens += n
                    st.prefill_keys += (new * (new + 1) - a * (a + 1)) // 2
                    st.prefill_kv_reads += n + (a if lv.first else 0)
                    takes.add(n)
                    lv.first = False
                    lv.pos = new
                    if new >= r.prompt_len:
                        st.first_tokens += 1
                        lv.done = True
            elif lv.done and r.state == RequestState.WAITING:
                lv.done, lv.pos = False, None     # preempted: recompute
            # tokens the caller can read now
            k = lv.seen
            while k < len(out) and out[k] is not None:
                k += 1
            if k > lv.seen:
                rec.token_times.extend([t] * (k - lv.seen))
                lv.seen = k
            if r.state == RequestState.FINISHED:
                if n_batch and rec.index not in self._finished:
                    # its last decode row ran in this step
                    self._finished.add(rec.index)
                    st.decode_keys += r.prompt_len + len(out) - 1
                if lv.seen >= len(out):
                    done.append(lv)
                    continue
            keep.append(lv)
        self.live = keep
        if n_batch:
            st.decode_rows = n_batch
            st.decode_keys += sum(r.prompt_len + len(r.output_tokens) - 1
                                  for r in eng.active)
        st.forwards = (1 if n_batch else 0) + sum(
            -(-n // eng.prefill_chunk) if n > eng.prefill_chunk else 1
            for n in takes)
        b = eng.blocks
        st.used_tokens = b.physical_used_tokens
        st.resident_tokens = (b.num_blocks - b.physical_free_blocks) \
            * b.block_size
        if n_batch or st.prefill_tokens:
            self.steps.append(st)
        return done

    # -- the loop ---------------------------------------------------------
    def run(self) -> Dict[str, Dict[str, float]]:
        """Serve the warm phase and the window; returns the engine's
        counters at the window's start and end, and the indices of its
        batch and host traces there."""
        eng, tr = self.eng, self.tracer
        self._finished = set()
        pending = sorted(self.plan.warm + self.plan.window,
                         key=lambda p: p.due if p.due is not None else 0.0)
        closed = self.plan.clients > 0
        if closed:
            queue = list(self.plan.window)
            pending = []
        clock = time.perf_counter
        t0 = clock() + self.warm            # the window's start
        self.t0_abs = t0
        marks: Dict[str, Dict[str, float]] = {}
        if closed:
            now = clock() - t0
            for _ in range(self.plan.clients):
                self._submit(queue.pop(0), now, now)
        i = 0
        n_batch = len(eng.batch_trace)
        while True:
            now = clock() - t0
            if "start" not in marks and now >= 0:
                marks["start"] = {**counters(eng),
                                  "batch_i": len(eng.batch_trace),
                                  "host_i": len(eng.step_host_trace)}
            if now >= self.seconds:
                break
            if tr is not None and not tr.done and not tr.on \
                    and now >= tr.start:
                tr.begin()
            with tr.range("perfbench.submit") if tr else _NULL:
                while i < len(pending) and pending[i].due <= now:
                    p = pending[i]
                    self._submit(p, p.due, clock() - t0)
                    i += 1
            traced = tr is not None and tr.on
            with tr.range("perfbench.step") if tr else _NULL:
                busy = eng.step()
            t = clock() - t0
            with tr.range("perfbench.account") if tr else _NULL:
                nb = len(eng.batch_trace)
                done = self._account(t, eng.batch_trace[-1]
                                     if nb > n_batch else 0, traced)
                n_batch = nb
                if closed:
                    for _ in done:
                        if queue:
                            self._submit(queue.pop(0), t, clock() - t0)
            if self.on_step is not None:
                self.on_step(self, t)
            if not busy and not closed:
                # idle until the next request falls due
                with tr.range("perfbench.idle") if tr else _NULL:
                    nxt = pending[i].due if i < len(pending) \
                        else self.seconds
                    wait = min(nxt, self.seconds) - (clock() - t0)
                    if wait > 0:
                        time.sleep(wait)
        if tr is not None and tr.on:
            # after the window: the profiler's stop takes seconds
            tr.end()
        # due in the window but never sent: the loop fell behind
        for p in pending[i:]:
            if p.due < self.seconds:
                self.reqs.append(record.Req(
                    index=len(self.reqs), warm=p.warm, due=p.due,
                    submitted=self.seconds, prompt_len=p.prompt_len,
                    max_new=p.max_new, doc=p.doc))
        marks["end"] = {**counters(eng), "batch_i": len(eng.batch_trace),
                        "host_i": len(eng.step_host_trace)}
        return marks
