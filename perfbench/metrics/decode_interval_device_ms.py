"""Mean device time of the window's timed intervals (those of the traced
slice) that ran a decode step and no prefill chunk, in ms: the stream's
time from a CUDA event recorded before the interval's first work to its
readback event (the engine's `Interval.device_ms`), gaps in which the
stream waited for the host included."""
from perfbench.program_trace import device_ms

LAYER = "model step"
UNIT = "ms"
MOVES = "tbt_mean_ms"
BETTER = "lower"
SOURCE = "program_span"


def read(run):
    return device_ms(run, fused=False)
