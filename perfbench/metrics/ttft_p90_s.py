"""p90 over the requests due in the window of the time from when each was
due to its first visible token. A request still without one at the
window's end (or refused) enters with its wait so far, a lower bound, so
a backlog or a stall raises the tail."""
from perfbench.stats import percentile

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    waits = [(r.token_times[0] if r.token_times and not r.rejected
              else run.seconds) - r.due for r in run.window_reqs]
    return percentile(waits, 90)
