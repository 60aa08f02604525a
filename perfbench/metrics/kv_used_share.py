"""Mean over the window's steps of the allocator's distinct used blocks
(`physical_used_tokens`) as a share of the pool, in %."""
LAYER = "allocator"
UNIT = "%"
MOVES = "throughput_tok_s"
BETTER = "higher"
SOURCE = "program_counter"


def read(run):
    if not run.steps or not run.pool_tokens:
        return None
    return 100.0 * sum(s.used_tokens for s in run.steps) / (
        len(run.steps) * run.pool_tokens)
