"""p80 over the requests due in the window of the time from when each was
due to its first visible token (a request without one by the window's end,
or refused, enters with its wait so far): the tail that keeps ten samples
beyond it at ~60 requests a window, where p90 keeps six."""
from perfbench.stats import percentile

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    waits = [(r.token_times[0] if r.token_times and not r.rejected
              else run.seconds) - r.due for r in run.window_reqs]
    return percentile(waits, 80)
