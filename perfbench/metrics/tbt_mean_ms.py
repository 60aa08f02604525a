"""Mean of every gap between two consecutive visible tokens of one request
inside the window, in ms: the decode pace a user averages, which moves
smoothly where the median jumps between decode-only and fused
intervals."""
from perfbench.stats import mean

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return mean(run.gaps_ms())
