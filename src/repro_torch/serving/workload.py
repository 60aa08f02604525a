"""Non-stationary workloads + trace replay: the paper's lambda(t) dynamics
(§II-B) and production-shaped traces (DESIGN §15).

Generators produce (arrival_time, prompt_len, output_len) streams for the
simulator: Poisson baseline, square-wave bursts (traffic spikes), diurnal
sinusoid, and replay from a JSONL trace file. The non-homogeneous
generators sample by Lewis–Shedler thinning — candidate gaps at the peak
rate, accepted with probability lambda(t)/max_rate — so realized
per-window rates match lambda(t) even when a quiet-rate gap would have
stepped clean over an entire burst window.

`shared_prefix` produces token-level streams (arrival_time, prompt_tokens,
output_len) for the prefix-sharing path (DESIGN §10): prompts draw a system
prompt from a fixed pool and conversations re-arrive multi-turn, each next
turn's prompt extending the previous turn's full transcript — the traffic
shape where vLLM-style prefix caching pays off. The same stream drives the
simulator (`feed_tokens`) and the serving engine, so hit rates are
directly comparable.

Trace replay (DESIGN §15) unifies both stream shapes under one versioned,
validated JSONL schema: a header line `{"schema": "repro-trace",
"version": 1, "kind": "lengths"|"tokens"}` followed by one record per
request (`t`, `l_out`, and `l_in` or `tokens`; optional `id`/`parent_id`
for ShareGPT-style multi-turn conversation structure). `save_trace`/
`load_trace` roundtrip Arrival and TokenArrival streams alike;
`load_trace_events` returns validated `TraceEvent`s with `path:line`
errors on malformed records; `reference_trace` synthesizes a bundled
ShareGPT/Azure-LLM-shaped trace so CI never needs an external download.

The port's copy of the JAX package's `serving/workload.py`: with the same
seed a generator gives the same arrivals, and both packages write and read
the same `repro-trace` files byte for byte.
"""
from __future__ import annotations

import dataclasses
import json
import math
import random
import warnings
from typing import Callable, List, Optional, Tuple

from repro_torch.serving.request import Request
from repro_torch.serving.sim import LengthDist, ServingSimulator, _lognorm

Arrival = Tuple[float, int, int]            # (t, l_in, l_out)
TokenArrival = Tuple[float, List[int], int]  # (t, prompt_tokens, l_out)

TRACE_SCHEMA = "repro-trace"
TRACE_VERSION = 1


def poisson(rate: float, n: int, lengths: LengthDist,
            seed: int = 0) -> List[Arrival]:
    rng = random.Random(seed)
    t, out = 0.0, []
    for _ in range(n):
        li, lo = lengths.sample(rng)
        out.append((t, li, lo))
        t += rng.expovariate(rate)
    return out


def _thinned_arrivals(rate_fn: Callable[[float], float], max_rate: float,
                      n: int, lengths: LengthDist,
                      rng: random.Random) -> List[Arrival]:
    """Lewis–Shedler thinning for a non-homogeneous Poisson process:
    candidate arrivals at the constant peak rate, each kept with
    probability lambda(t)/max_rate. Unlike drawing each gap from lambda
    at the current instant, no window of elevated rate can be stepped
    over — the realized rate in every window matches lambda(t)."""
    t, out = 0.0, []
    while len(out) < n:
        t += rng.expovariate(max_rate)
        if rng.random() * max_rate <= rate_fn(t):
            li, lo = lengths.sample(rng)
            out.append((t, li, lo))
    return out


def bursty(base_rate: float, burst_rate: float, period_s: float,
           duty: float, n: int, lengths: LengthDist,
           seed: int = 0) -> List[Arrival]:
    """Square-wave lambda(t): base_rate, spiking to burst_rate for
    duty*period every period. Sampled by Lewis–Shedler thinning so a
    quiet-rate gap cannot skip a whole burst window."""
    rng = random.Random(seed)

    def lam(t: float) -> float:
        return burst_rate if (t % period_s) / period_s < duty else base_rate

    return _thinned_arrivals(lam, max(base_rate, burst_rate), n, lengths,
                             rng)


def diurnal(mean_rate: float, amplitude: float, period_s: float, n: int,
            lengths: LengthDist, seed: int = 0) -> List[Arrival]:
    rng = random.Random(seed)

    def lam(t: float) -> float:
        return max(mean_rate * (1 + amplitude *
                                math.sin(2 * math.pi * t / period_s)), 1e-3)

    max_rate = max(mean_rate * (1 + abs(amplitude)), 1e-3)
    return _thinned_arrivals(lam, max_rate, n, lengths, rng)


def shared_prefix(rate: float, n: int, *, vocab_size: int = 1000,
                  n_system_prompts: int = 4, system_len: int = 64,
                  user_len: Tuple[int, int] = (8, 32),
                  mean_out: float = 24.0, p_followup: float = 0.5,
                  max_turns: int = 4, turn_gap_s: float = 5.0,
                  seed: int = 0) -> List[TokenArrival]:
    """Shared-system-prompt, multi-turn token workload (DESIGN §10).

    Each conversation opens with one of `n_system_prompts` fixed system
    prompts (`system_len` tokens, deterministic per pool entry) plus fresh
    user tokens. With probability `p_followup` (up to `max_turns` turns) it
    re-arrives `turn_gap_s` later, its next prompt = the previous prompt +
    the previous turn's transcript (synthetic assistant tokens of the
    sampled output length) + a new user utterance — the traffic where every
    turn's prefill is dominated by already-seen tokens. Poisson arrivals at
    `rate` for conversation openers; `n` total requests."""
    rng = random.Random(seed)
    pool = [[rng.randrange(vocab_size) for _ in range(system_len)]
            for _ in range(n_system_prompts)]

    def utterance():
        return [rng.randrange(vocab_size)
                for _ in range(rng.randint(*user_len))]

    def out_len():
        return max(1, int(rng.expovariate(1.0 / mean_out)))

    out: List[TokenArrival] = []
    t = 0.0
    while len(out) < n:
        prompt = list(rng.choice(pool)) + utterance()
        turn_t = t
        for turn in range(max_turns):
            lo = out_len()
            out.append((turn_t, list(prompt), lo))
            if len(out) >= n or rng.random() >= p_followup:
                break
            # next turn extends the transcript: previous prompt + synthetic
            # assistant reply + a fresh user utterance
            prompt = prompt + [rng.randrange(vocab_size) for _ in range(lo)] \
                + utterance()
            turn_t += turn_gap_s * (1.0 + rng.random())
        t += rng.expovariate(rate)
    out.sort(key=lambda a: a[0])
    return out[:n]


def feed_tokens(sim: ServingSimulator, arrivals: List[TokenArrival]) -> None:
    """Inject a token-level arrival stream (prefix-sharing workloads): the
    sim's BlockManager matches/registers these prompts exactly like the
    engine does (DESIGN §10)."""
    base = len(sim._all)
    new = [Request(rid=base + i, arrival_time=t, prompt_tokens=list(toks),
                   true_output_len=lo, max_new_tokens=sim.serve.max_new_tokens)
           for i, (t, toks, lo) in enumerate(arrivals)]
    sim.waiting.extend(new)
    sim.waiting.sort(key=lambda r: r.arrival_time)
    sim._all.extend(new)


def feed(sim: ServingSimulator, arrivals: List[Arrival]) -> None:
    """Inject a pre-built arrival stream into a simulator. Safe on a sim
    that already holds requests, and safe to call repeatedly: rids are
    offset past the existing population and only the NEW requests extend
    the sim's bookkeeping (`_all`), so TTFT/goodput aggregation never sees
    duplicate or colliding entries."""
    base = len(sim._all)
    new = [Request(rid=base + i, arrival_time=t, prompt_len=li,
                   true_output_len=lo,
                   max_new_tokens=sim.serve.max_new_tokens)
           for i, (t, li, lo) in enumerate(arrivals)]
    sim.waiting.extend(new)
    sim.waiting.sort(key=lambda r: r.arrival_time)
    sim._all.extend(new)


# ---------------------------------------------------------------------------
# trace replay (DESIGN §15)


class TraceFormatError(ValueError):
    """Malformed trace file: message carries `path:line` context."""


@dataclasses.dataclass
class TraceEvent:
    """One request of a replayable trace (DESIGN §15).

    `l_in` always holds the prompt length; token-level records carry the
    prompt itself in `tokens`. `parent_id` links multi-turn conversation
    structure (the previous turn of the same conversation) and must
    reference an earlier record."""
    t: float
    l_out: int
    l_in: int = 0
    tokens: Optional[List[int]] = None
    id: Optional[int] = None
    parent_id: Optional[int] = None

    @property
    def prompt_len(self) -> int:
        return len(self.tokens) if self.tokens is not None else self.l_in


def _as_events(arrivals) -> List[TraceEvent]:
    """Normalize Arrival tuples, TokenArrival tuples, or TraceEvents into
    TraceEvents (tuples get sequential ids; events keep theirs)."""
    evs: List[TraceEvent] = []
    for i, a in enumerate(arrivals):
        if isinstance(a, TraceEvent):
            evs.append(a if a.id is not None
                       else dataclasses.replace(a, id=i))
            continue
        t, mid, lo = a
        if isinstance(mid, (list, tuple)):
            evs.append(TraceEvent(t=float(t), l_out=int(lo), l_in=len(mid),
                                  tokens=list(mid), id=i))
        else:
            evs.append(TraceEvent(t=float(t), l_out=int(lo), l_in=int(mid),
                                  id=i))
    return evs


def save_trace(path: str, arrivals) -> None:
    """Write a versioned repro-trace JSONL file (DESIGN §15): one header
    line (schema/version/kind) then one record per request. Accepts
    Arrival tuples, TokenArrival tuples, or TraceEvents (multi-turn
    `parent_id` links preserved); the kind is `tokens` iff any record
    carries prompt tokens."""
    evs = _as_events(list(arrivals))
    kind = "tokens" if any(e.tokens is not None for e in evs) else "lengths"
    with open(path, "w") as f:
        f.write(json.dumps({"schema": TRACE_SCHEMA,
                            "version": TRACE_VERSION, "kind": kind}) + "\n")
        for e in evs:
            rec = {"id": e.id, "t": e.t, "l_out": e.l_out}
            if e.tokens is not None:
                rec["l_in"] = len(e.tokens)
                rec["tokens"] = list(e.tokens)
            else:
                rec["l_in"] = e.l_in
            if e.parent_id is not None:
                rec["parent_id"] = e.parent_id
            f.write(json.dumps(rec) + "\n")


def _fail(path: str, lineno: int, msg: str):
    raise TraceFormatError(f"{path}:{lineno}: {msg}")


def _parse_obj(path: str, lineno: int, line: str) -> dict:
    try:
        rec = json.loads(line)
    except json.JSONDecodeError as e:
        raise TraceFormatError(
            f"{path}:{lineno}: not valid JSON ({e})") from None
    if not isinstance(rec, dict):
        _fail(path, lineno, f"every line must be a JSON object, "
                            f"got {type(rec).__name__}")
    return rec


def _is_int(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def load_trace_events(path: str) -> List[TraceEvent]:
    """Read and validate a repro-trace file (DESIGN §15) into TraceEvents.

    Every malformed or missing-field line raises `TraceFormatError` with
    the `path:line` it came from (never a bare KeyError). Headerless files
    are accepted as legacy version-1 length traces. Records whose
    timestamps are out of order are sorted with a warning."""
    with open(path) as f:
        lines = f.readlines()
    kind, start = "lengths", 0
    if lines:
        first = _parse_obj(path, 1, lines[0])
        if "schema" in first:
            if first["schema"] != TRACE_SCHEMA:
                _fail(path, 1, f"unknown schema {first['schema']!r} "
                               f"(want {TRACE_SCHEMA!r})")
            ver = first.get("version")
            if ver != TRACE_VERSION:
                _fail(path, 1, f"unsupported version {ver!r} (this reader "
                               f"understands version {TRACE_VERSION})")
            kind = first.get("kind", "lengths")
            if kind not in ("lengths", "tokens"):
                _fail(path, 1, f"unknown kind {kind!r} "
                               f"(want 'lengths' or 'tokens')")
            start = 1
    events: List[TraceEvent] = []
    seen_ids = set()
    for off, line in enumerate(lines[start:]):
        lineno = start + off + 1
        if not line.strip():
            continue
        rec = _parse_obj(path, lineno, line)
        t = rec.get("t")
        if isinstance(t, bool) or not isinstance(t, (int, float)) or t < 0:
            _fail(path, lineno, f"'t' must be a number >= 0, got {t!r}")
        lo = rec.get("l_out")
        if not _is_int(lo) or lo < 1:
            _fail(path, lineno, f"'l_out' must be an int >= 1, got {lo!r}")
        tokens = None
        if kind == "tokens":
            tokens = rec.get("tokens")
            if not isinstance(tokens, list) or not tokens \
                    or not all(_is_int(x) and x >= 0 for x in tokens):
                _fail(path, lineno,
                      "'tokens' must be a non-empty list of ints >= 0")
            li = len(tokens)
        else:
            li = rec.get("l_in")
            if not _is_int(li) or li < 1:
                _fail(path, lineno,
                      f"'l_in' must be an int >= 1, got {li!r}")
        rid = rec.get("id", len(events))
        if not _is_int(rid):
            _fail(path, lineno, f"'id' must be an int, got {rid!r}")
        if rid in seen_ids:
            _fail(path, lineno, f"duplicate id {rid}")
        pid = rec.get("parent_id")
        if pid is not None:
            if not _is_int(pid):
                _fail(path, lineno,
                      f"'parent_id' must be an int, got {pid!r}")
            if pid not in seen_ids:
                _fail(path, lineno, f"parent_id {pid} does not reference "
                                    f"an earlier request")
        seen_ids.add(rid)
        events.append(TraceEvent(
            t=float(t), l_out=lo, l_in=int(li),
            tokens=list(tokens) if tokens is not None else None,
            id=rid, parent_id=pid))
    if any(events[i].t < events[i - 1].t for i in range(1, len(events))):
        warnings.warn(f"{path}: arrival timestamps out of order; sorting",
                      stacklevel=2)
        events.sort(key=lambda e: e.t)
    return events


def load_trace(path: str):
    """Load a trace as plain tuples: Arrival for `lengths` traces,
    TokenArrival for `tokens` traces (the `save_trace` roundtrip twin).
    Use `load_trace_events` to keep ids and `parent_id` links."""
    evs = load_trace_events(path)
    if any(e.tokens is not None for e in evs):
        return [(e.t, list(e.tokens), e.l_out) for e in evs]
    return [(e.t, e.l_in, e.l_out) for e in evs]


def reference_trace(n: int, *, seed: int = 0, vocab_size: int = 1000,
                    base_rate: float = 4.0, burst_rate: float = 16.0,
                    period_s: float = 40.0, duty: float = 0.25,
                    n_system_prompts: int = 4, system_len: int = 32,
                    user_mean: float = 24.0, out_mean: float = 32.0,
                    length_cv: float = 0.6, p_followup: float = 0.5,
                    max_turns: int = 3,
                    turn_gap_s: float = 5.0) -> List[TraceEvent]:
    """Bundled synthetic reference trace (DESIGN §15): ShareGPT/Azure-LLM
    shaped without any external download, so CI can replay it.

    Conversation openers arrive via a Lewis–Shedler-thinned square-wave
    lambda(t); each prompt opens with one of `n_system_prompts` shared
    system prompts plus a lognormal user utterance; output lengths are
    lognormal; with probability `p_followup` (up to `max_turns`) the
    conversation re-arrives `parent_id`-linked, its prompt extending the
    previous turn's full transcript. Events are sorted by arrival time
    with ids equal to file order, so every parent precedes its children."""
    rng = random.Random(seed)
    pool = [[rng.randrange(vocab_size) for _ in range(system_len)]
            for _ in range(n_system_prompts)]
    max_rate = max(base_rate, burst_rate)

    def lam(t: float) -> float:
        return burst_rate if (t % period_s) / period_s < duty else base_rate

    def ln_len(mean: float) -> int:
        return max(1, int(rng.lognormvariate(*_lognorm(mean, length_cv))))

    def utterance():
        return [rng.randrange(vocab_size) for _ in range(ln_len(user_mean))]

    events: List[TraceEvent] = []
    t = 0.0
    while len(events) < n:
        # next conversation opener via thinning (same law as `bursty`)
        while True:
            t += rng.expovariate(max_rate)
            if rng.random() * max_rate <= lam(t):
                break
        prompt = list(rng.choice(pool)) + utterance()
        turn_t, parent = t, None
        for turn in range(max_turns):
            lo = ln_len(out_mean)
            ev = TraceEvent(t=turn_t, l_out=lo, l_in=len(prompt),
                            tokens=list(prompt), id=len(events),
                            parent_id=parent)
            events.append(ev)
            parent = ev.id
            if len(events) >= n or rng.random() >= p_followup:
                break
            prompt = prompt + [rng.randrange(vocab_size) for _ in range(lo)] \
                + utterance()
            turn_t += turn_gap_s * (1.0 + rng.random())
    # follow-up turns always land later than their parent, so a stable
    # sort keeps every parent ahead of its children; remap ids to file
    # order so the saved trace validates on load
    order = sorted(range(len(events)), key=lambda i: events[i].t)
    remap = {events[i].id: pos for pos, i in enumerate(order)}
    return [dataclasses.replace(
        events[i], id=pos,
        parent_id=None if events[i].parent_id is None
        else remap[events[i].parent_id]) for pos, i in enumerate(order)]


def feed_trace(sim: ServingSimulator,
               events: List[TraceEvent]) -> List[Request]:
    """Inject validated TraceEvents into a simulator: token-level records
    replay through the BlockManager exactly like `feed_tokens` (prefix
    sharing sees the real prompts), length-only records replay like
    `feed`. Same rid-offset discipline — safe to call repeatedly."""
    base = len(sim._all)
    new = [Request(rid=base + i, arrival_time=e.t,
                   prompt_tokens=list(e.tokens)
                   if e.tokens is not None else None,
                   prompt_len=e.prompt_len, true_output_len=e.l_out,
                   max_new_tokens=sim.serve.max_new_tokens)
           for i, e in enumerate(events)]
    sim.waiting.extend(new)
    sim.waiting.sort(key=lambda r: r.arrival_time)
    sim._all.extend(new)
    return new


def trace_prompts(events: List[TraceEvent], vocab_size: int,
                  seed: int = 0) -> List[Tuple[List[int], int]]:
    """Materialize engine-submittable (prompt_tokens, l_out) pairs from a
    trace: token records pass through with ids clamped into the model's
    vocab, length-only records get deterministic synthetic tokens."""
    rng = random.Random(seed)
    out: List[Tuple[List[int], int]] = []
    for e in events:
        if e.tokens is not None:
            toks = [tok % vocab_size for tok in e.tokens]
        else:
            toks = [rng.randrange(vocab_size)
                    for _ in range(max(1, e.l_in))]
        out.append((toks, e.l_out))
    return out
