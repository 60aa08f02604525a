"""Median of every gap between two consecutive visible tokens of one
request inside the window: the decode interval as callers feel it."""
from perfbench.stats import percentile

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return percentile(run.gaps_ms(), 50)
