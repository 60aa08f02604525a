"""Mean rows of the window's decode steps (the engine's `batch_trace`): the
batch the controllers let run."""
from perfbench.stats import mean

LAYER = "controller"
UNIT = "rows"
MOVES = "throughput_tok_s"
BETTER = "higher"
SOURCE = "program_counter"


def read(run):
    return mean(run.batch_trace)
