"""Share of the traced slice in which no kernel, copy or memset ran on the
card, in %."""
LAYER = "device"
UNIT = "%"
MOVES = "throughput_tok_s"
BETTER = "lower"
SOURCE = "device_trace"


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
