"""Reads the profiler's trace of the traced slice: the device's busy time
(the union of kernel, copy and memset spans, a frozen copy of the rule in
`chip_smoke.py`'s `trace_interval`), the time of each device operation by
name, and the longest idle gaps, each named by the harness range
(`perfbench.submit`, `.step`, `.account`, `.idle`) the host was in when
the device went idle (`.sync`: the wait for the device that closes the
slice)."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Tuple

from perfbench.record import Trace

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: entries kept of each breakdown list
TOP = 10


def union(spans: List[Tuple[float, float]], t0: float, t1: float
          ) -> List[Tuple[float, float]]:
    """The union of `spans` clipped to [t0, t1], as disjoint sorted spans
    (the busy rule of `chip_smoke.trace_interval`)."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read_events(events: List[Dict]) -> Trace:
    """A `record.Trace` from chrome-trace events (times in µs). The slice
    runs from the start of the harness's first range to the end of its
    last (the last waits for the device to finish)."""
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                    for e in events if e.get("ph") == "X"
                    and str(e.get("name", "")).startswith("perfbench."))
    if not ranges:
        raise ValueError("the trace holds no perfbench range")
    t0 = ranges[0][0]
    t1 = max(b for _, b, _ in ranges)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e.get("ph") == "X"]
    busy = union([(e["ts"], e["ts"] + e.get("dur", 0)) for e in dev], t0, t1)
    ops: Dict[str, float] = {}
    for e in dev:
        a, b = max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1)
        if b > a:
            ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a) * 1e-6
    # idle gaps, named by the innermost harness range open at their start
    starts = [r[0] for r in ranges]
    gaps = []
    edges = [(t0, t0)] + busy + [(t1, t1)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b <= a:
            continue
        k = bisect.bisect_right(starts, a)
        name = "host"
        for s, e, n in reversed(ranges[max(0, k - 8):k]):
            if s <= a < e:
                name = n
                break
        gaps.append((name, (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return Trace(window_s=(t1 - t0) * 1e-6,
                 busy_s=sum(b - a for a, b in busy) * 1e-6,
                 device_ops=sorted(ops.items(), key=lambda o: -o[1]),
                 idle_gaps=gaps[:TOP])


def read(prof) -> Trace:
    """Export the profiler's trace to a temporary file, read it, and
    delete it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return read_events(events)


def breakdown(tr: Trace) -> Dict[str, List]:
    return {"device_ops": [[n, s] for n, s in tr.device_ops[:TOP]],
            "idle_gaps": [[n, s] for n, s in tr.idle_gaps[:TOP]]}
