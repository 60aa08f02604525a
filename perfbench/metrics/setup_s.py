"""Seconds from the process's start to the window's: imports, the weights,
kernel builds and loads, the engine's pool and captured graphs, set-up's
documents and the warm phase."""
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
