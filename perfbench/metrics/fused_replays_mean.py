"""Mean over the window's intervals that ran prefill chunks of the compiled
steps each dispatched (the engine's `Interval.replays`): each replay reads
all of the model's weights, so this counts the passes over the weights
that a fused interval makes. None where the program keeps no such count
(a tree before it)."""
from perfbench.program_trace import window
from perfbench.stats import mean

LAYER = "model step"
UNIT = "replays"
MOVES = "tbt_p95_ms"
BETTER = "lower"
SOURCE = "program_counter"


def read(run):
    w = window(run)
    if w is None:
        return None
    return mean([iv.replays for iv in w.intervals
                 if iv.prefill_tokens > 0
                 and getattr(iv, "replays", None) is not None])
