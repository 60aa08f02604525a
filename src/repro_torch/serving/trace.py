"""The serving engine's own tracing: named spans on the profiler's clock,
one record a busy interval, and the window-scoped view that readers take.

Spans are `torch.profiler.record_function` ranges, live exactly while a
profiler is collecting (the engine asks `torch.autograd._profiler_enabled()`
once a busy `step()`); otherwise `span` returns one shared null context.
A range lands in the profiler's trace on the same clock as the kernels and
copies, so an idle gap on the device can be put down to the engine phase
that was open on the host when it began. The names form a fixed set:

    engine.step          the busy part of `Engine.step()`
    engine.schedule      the telemetry snapshot and the policy (Alg 1, Alg 2)
    engine.admit         swap-in drain, admission, released blocks, preemption
    engine.prefill       the interval's prefill chunks (`_advance_prefill`)
    engine.decode        the decode step, or the mixed step that runs the
                         lanes' chunks with it (`_decode_once`)
    engine.readback      the readback's dispatch
    engine.retire        one retirement (`_retire_step`)
    engine.retire.wait   its wait on the readback event: the loop's one wait
    step.decode, step.mixed, step.chunk, step.xchunk
                         one compiled step's run (`graphs.Step.run`, from
                         `Engine._run`), named by its shape key's first
                         element
    graphs.capture       one CUDA graph capture (`StepGraphs.capture`)

With spans on, on the card, each interval also times its stream, from a
CUDA event recorded before its first work to its readback event
(`Interval.device_ms`, set at retirement): the device time of one interval
under dispatch-ahead, where the retirement's wait is only the part the
host did not hide. With spans off the events are the untimed ones the
engine records anyway.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

_NULL = contextlib.nullcontext()

#: `graphs.Step.run`'s span, by the first element of the step's shape key
STEP_SPANS = {"decode": "step.decode", "mixed": "step.mixed",
              "chunk": "step.chunk", "xchunk": "step.xchunk"}


def span(on: bool, name: str):
    """A profiler range named `name` when `on`, else the shared null
    context."""
    return torch.profiler.record_function(name) if on else _NULL


class Interval:
    """One busy `step()`, index-aligned with the engine's
    `step_host_trace`; times on the engine clock (`Engine._now()`)."""
    __slots__ = ("t", "t_end", "n_decode", "prefill_tokens", "chunk_budget",
                 "device_ms", "replays")

    def __init__(self, t: float):
        self.t = t                  # the interval's start
        self.t_end = t              # its end (set as step() returns)
        self.n_decode = 0           # rows of its decode step, or 0
        #: prompt tokens it dispatched
        self.prefill_tokens = 0
        #: the token budget its prefill chunks were packed in (Alg 2's b_t
        #: as granted); None where no request was prefilling
        self.chunk_budget: Optional[int] = None
        #: its stream's time from its first work to its readback, in ms;
        #: None unless timed (spans on, on the card) and retired
        self.device_ms: Optional[float] = None
        #: the compiled steps it ran (`Engine._run`): each a graph replay
        #: on the card, so each a pass over the weights
        self.replays = 0


class Window:
    """Intervals [i0, i1) of a trace and the requests that arrived in
    them: after the interval before i0 ended (any time before, if i0 is 0)
    up to the end of interval i1 - 1, so that a request submitted between
    two calls counts in the interval that follows it."""
    __slots__ = ("intervals", "requests", "t0", "t1")

    def __init__(self, intervals: List[Interval], requests: list,
                 t0: float, t1: float):
        self.intervals, self.requests = intervals, requests
        self.t0, self.t1 = t0, t1


class EngineTrace:
    """An engine's intervals and the requests submitted to it. Holds no
    device tensor and no CUDA event."""

    def __init__(self):
        self.intervals: List[Interval] = []
        self.requests: list = []
        global _LATEST
        _LATEST = self

    def window(self, i0: int, i1: int) -> Window:
        iv = self.intervals[i0:i1]
        if not iv:
            return Window([], [], 0.0, 0.0)
        t0 = self.intervals[i0 - 1].t_end if i0 > 0 else float("-inf")
        t1 = iv[-1].t_end
        reqs = [r for r in self.requests if t0 <= r.arrival_time <= t1]
        return Window(iv, reqs, t0, t1)


_LATEST: Optional[EngineTrace] = None


def latest() -> Optional[EngineTrace]:
    """The trace of the engine built last in this process (it outlives the
    engine, as `kernels.ops.LAUNCHES` outlives the steps)."""
    return _LATEST
