"""The model's operations for the window's served tokens over the window's
seconds at the card's bf16 peak, in %: every decode row and prefill token
through the projections, each row of logits computed for a token the
caller gets, and each query against its visible keys."""
from perfbench.peaks import BF16_FLOPS

LAYER = "model step"
UNIT = "%"
MOVES = "tbt_mean_ms"
BETTER = "higher"
SOURCE = "program_counter"


def flops(fam, c, s):
    return ((s.decode_rows + s.prefill_tokens) * fam.token_flops(c)
            + (s.decode_rows + s.first_tokens) * fam.head_flops(c)
            + (s.decode_keys + s.prefill_keys)
            * fam.attention_flops_per_key(c))


def read(run):
    if not run.steps:
        return None
    total = sum(flops(run.family, run.config, s) for s in run.steps)
    return 100.0 * total / (run.seconds * BF16_FLOPS)
