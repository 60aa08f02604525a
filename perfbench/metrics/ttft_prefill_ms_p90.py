"""p90 over the requests that arrived in the window and had a first
prefill chunk of the time from it to their first token (the engine's
`first_token_time` minus `prefill_start_time`), in ms; a request without
a first token by the window's end enters with the time so far. The
prefill-service part of the TTFT tail: the chunk budget and the lanes."""
from perfbench.program_trace import window
from perfbench.stats import percentile

LAYER = "engine"
UNIT = "ms"
MOVES = "ttft_p90_s"
BETTER = "lower"
SOURCE = "program_span"


def read(run):
    w = window(run)
    if w is None:
        return None
    spans = []
    for r in w.requests:
        ps, ft = r.prefill_start_time, r.first_token_time
        if r.rejected or not 0.0 <= ps <= w.t1:
            continue
        spans.append((ft if ps <= ft <= w.t1 else w.t1) - ps)
    return percentile([x * 1e3 for x in spans], 90)
