"""Mean over the window's steps of the pool's blocks that hold K/V, the
used ones and the prefix index's evictable cached ones, as a share of the
pool, in %: how much of the pool the traffic fills."""
LAYER = "memory tiers"
UNIT = "%"
MOVES = "ttft_p90_s"
BETTER = "higher"
SOURCE = "program_counter"


def read(run):
    if not run.steps or not run.pool_tokens:
        return None
    return 100.0 * sum(s.resident_tokens for s in run.steps) / (
        len(run.steps) * run.pool_tokens)
