"""Prompt tokens served from shared blocks over prompt tokens queried, of
the admissions in the window (the BlockManager's counters), in %."""
LAYER = "memory tiers"
UNIT = "%"
MOVES = "ttft_p90_s"
BETTER = "higher"
SOURCE = "program_counter"


def read(run):
    q = run.end["prefix_query_tokens"] - run.start["prefix_query_tokens"]
    if q <= 0:
        return None
    return 100.0 * (run.end["prefix_hit_tokens"]
                    - run.start["prefix_hit_tokens"]) / q
