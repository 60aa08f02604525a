"""Bytes the window's steps need over the window's seconds at the card's
HBM bandwidth, in %: every weight once a forward (an interval's decode
step and each size of prefill chunk it ran) and each decode row's
visible K/V once."""
from perfbench.peaks import HBM_BPS

LAYER = "model step"
UNIT = "%"
MOVES = "tbt_mean_ms"
BETTER = "higher"
SOURCE = "program_counter"


def read(run):
    if not run.steps:
        return None
    fam, c = run.family, run.config
    total = sum(s.forwards * fam.weight_bytes(c)
                + s.decode_keys * fam.kv_bytes_per_position(c)
                for s in run.steps)
    return 100.0 * total / (run.seconds * HBM_BPS)
