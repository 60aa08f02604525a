"""Mean over the window's intervals in which a request was prefilling of
the prompt-token budget the interval's chunks were packed in (Alg 2's b_t
as granted, after the engine's fallbacks; the engine's
`Interval.chunk_budget`)."""
from perfbench.program_trace import window
from perfbench.stats import mean

LAYER = "controller"
UNIT = "tokens"
MOVES = "ttft_p90_s"
BETTER = "higher"
SOURCE = "program_counter"


def read(run):
    w = window(run)
    if w is None:
        return None
    return mean([iv.chunk_budget for iv in w.intervals
                 if iv.chunk_budget is not None])
