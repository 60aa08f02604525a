"""What a run records, from the client's side, for the metrics' readers.

Times are host seconds from the start of the measured window (the warm
phase's are negative); a token's time is the return of the `Engine.step()`
call after which the caller could read it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Req:
    """One request as its user saw it."""
    index: int
    warm: bool
    due: float                  # when it was due to be sent
    submitted: float            # when the harness submitted it
    prompt_len: int
    max_new: int
    doc: Optional[int] = None
    rejected: bool = False
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def finished(self) -> bool:
        return len(self.token_times) >= self.max_new


@dataclasses.dataclass
class Step:
    """One `Engine.step()` call that dispatched work: when it returned,
    and the work it dispatched, counted from the engine's request state
    (prefill positions, decode rows and their contexts)."""
    t: float
    decode_rows: int = 0
    #: keys (K/V positions) visible to the step's decode rows, summed
    decode_keys: int = 0
    prefill_tokens: int = 0
    #: keys visible to each prefill token (causal), summed
    prefill_keys: int = 0
    #: K/V positions a least prefill reads: each prompt's positions once
    #: (a shared prefix once a request, with the request's first chunk)
    prefill_kv_reads: int = 0
    #: requests whose last prompt chunk ran (each computes one row of
    #: logits for its first token)
    first_tokens: int = 0
    #: forward passes the interval ran: its decode step and one a size
    #: of prefill chunk (each reads every weight once)
    forwards: int = 0
    #: the allocator's distinct used blocks after the step, in tokens
    used_tokens: int = 0
    #: blocks holding K/V after the step, in tokens: the used ones and the
    #: prefix index's evictable cached ones
    resident_tokens: int = 0
    traced: bool = False


@dataclasses.dataclass
class Trace:
    """The profiler's reading of the traced slice of the window."""
    window_s: float
    busy_s: float
    #: (kernel or copy name, seconds) of every device operation
    device_ops: List[Tuple[str, float]]
    #: the longest idle gaps, each named by the harness range the host was
    #: in when it began
    idle_gaps: List[Tuple[str, float]]


@dataclasses.dataclass
class Run:
    """Everything a metric may read."""
    cell: Dict
    config: Dict
    seconds: float
    setup_s: float
    reqs: List[Req]
    steps: List[Step]
    #: the engine's counters at the window's start and end
    start: Dict[str, float]
    end: Dict[str, float]
    #: the controller's decode batch of each decode step in the window
    batch_trace: List[int]
    #: the engine's own host seconds of each step() in the window
    step_host: List[float]
    pool_tokens: int
    trace: Optional[Trace] = None
    #: the configuration's plain reference module (`families/<family>.py`):
    #: its operation and byte counts
    family: object = None

    @property
    def window_reqs(self) -> List[Req]:
        """The requests due in the window."""
        return [r for r in self.reqs if not r.warm]

    def gaps_ms(self) -> List[float]:
        """Every gap between two consecutive visible tokens of one request,
        both inside the window, in ms."""
        out = []
        for r in self.reqs:
            ts = [t for t in r.token_times if 0.0 <= t <= self.seconds]
            out.extend((b - a) * 1e3 for a, b in zip(ts, ts[1:]))
        return out
