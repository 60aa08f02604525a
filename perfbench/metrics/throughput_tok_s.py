"""Output tokens made visible to callers in the window, per second of the
window (warm-phase requests' tokens included: they are served in it)."""
UNIT = "tokens/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    n = sum(1 for r in run.reqs for t in r.token_times
            if 0.0 <= t <= run.seconds)
    return n / run.seconds
