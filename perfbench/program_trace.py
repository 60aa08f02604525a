"""The engine's own trace (`repro_torch.serving.trace`) over a run's
window, for the readers of the program's spans and counters: the intervals
of the window's `step()` calls (`run.start["host_i"]` to
`run.end["host_i"]`, index-aligned with `step_host_trace`) and the
requests that arrived in them. None, and never an error, where the program
keeps no such trace (a tree before it), where its trace is shorter than
the window, or where the window holds no interval."""
from __future__ import annotations


def window(run):
    try:
        from repro_torch.serving import trace
    except ImportError:
        return None
    tr = trace.latest()
    i0 = int(run.start.get("host_i", -1))
    i1 = int(run.end.get("host_i", -1))
    if tr is None or i0 < 0 or i1 <= i0 or len(tr.intervals) < i1:
        return None
    return tr.window(i0, i1)


def device_ms(run, fused: bool):
    """Mean device ms of the window's timed intervals: those that ran
    prefill chunks (`fused`), or those that only decoded."""
    w = window(run)
    if w is None:
        return None
    ms = [iv.device_ms for iv in w.intervals if iv.device_ms is not None
          and (iv.prefill_tokens > 0 if fused
               else iv.n_decode > 0 and iv.prefill_tokens == 0)]
    return sum(ms) / len(ms) if ms else None
