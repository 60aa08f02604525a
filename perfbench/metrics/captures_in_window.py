"""CUDA graph captures the engine made inside the window
(`graphs.stats()["captures"]`): each is a compile on the timed path."""
LAYER = "compiled step"
UNIT = "count"
MOVES = "tbt_p95_ms"
BETTER = "lower"
SOURCE = "program_counter"


def read(run):
    return run.end["captures"] - run.start["captures"]
