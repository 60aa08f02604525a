"""Mean device time of the window's timed intervals that ran prefill chunks
(with or without a decode step), in ms, timed as
`decode_interval_device_ms` is: the fused intervals that make the TBT
tail."""
from perfbench.program_trace import device_ms

LAYER = "model step"
UNIT = "ms"
MOVES = "tbt_p95_ms"
BETTER = "lower"
SOURCE = "program_span"


def read(run):
    return device_ms(run, fused=True)
