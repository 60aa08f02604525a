"""p90 over the requests that arrived in the window of their wait before
their first prefill chunk (the engine's `prefill_start_time` minus
`arrival_time`), in ms; a request without a chunk by the window's end
enters with its wait so far. The queueing part of the TTFT tail."""
from perfbench.program_trace import window
from perfbench.stats import percentile

LAYER = "controller"
UNIT = "ms"
MOVES = "ttft_p90_s"
BETTER = "lower"
SOURCE = "program_span"


def read(run):
    w = window(run)
    if w is None:
        return None
    waits = []
    for r in w.requests:
        if r.rejected:
            continue
        if 0.0 <= r.prefill_start_time <= w.t1:
            waits.append(r.prefill_start_time - r.arrival_time)
        elif r.first_token_time < 0.0:
            waits.append(w.t1 - r.arrival_time)
    return percentile([x * 1e3 for x in waits], 90)
