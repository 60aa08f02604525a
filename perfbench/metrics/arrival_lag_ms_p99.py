"""p99 over the window's requests of submit time minus due time: how late
the harness ran the open loop (a step() call it had to wait for)."""
from perfbench.stats import percentile

LAYER = "load generator"
UNIT = "ms"
MOVES = "ttft_p90_s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return percentile([(r.submitted - r.due) * 1e3
                       for r in run.window_reqs], 99)
