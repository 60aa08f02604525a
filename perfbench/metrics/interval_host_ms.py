"""Mean of the engine's host seconds a step() (`step_host_trace`: the call
less its waits for the device) in the window, in ms."""
from perfbench.stats import mean

LAYER = "engine"
UNIT = "ms"
MOVES = "tbt_mean_ms"
BETTER = "lower"
SOURCE = "program_span"


def read(run):
    m = mean(run.step_host)
    return None if m is None else m * 1e3
