"""p95 of the same gaps as `tbt_p50_ms`: the intervals that fused prefill
chunks, a capture or a stall lengthened."""
from perfbench.stats import percentile

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return percentile(run.gaps_ms(), 95)
