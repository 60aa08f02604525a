"""Prefix sharing on the port (DESIGN §10): granite-3-8b on the paged pool
serving a shared-system-prompt multi-turn stream with `--prefix-cache` off
and on, beside the port's simulator on the same token stream. The port's
counterpart of `benchmarks/prefix_caching.py`.

    python src/repro_torch/bench/prefix_caching.py [--variant reduced|full]
        [--device cuda|cpu] [--src DIR] [--mode off on]

The stream is `workload.shared_prefix` (16 conversations' turns on 4
system prompts of 256 tokens, 16-64 user tokens, follow-ups 120 s apart),
submitted in 60 s waves as the reference bench does: each wave at once,
served to completion before the next. The flags are `chip_smoke.py`'s
serve flags with `--policy static --pool-tokens 8192 --paged`. Prints the
card's name and power limit (on the card), then one JSON line a mode: the
reference bench's metrics (TTFT mean and p90, hit rate and tokens,
`copy_bytes`, `cached_blocks`, `cache_evictions`), prefill tokens, the
interval's host and device means, and the simulator's counters on the same
waves.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import List

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import kv_swap  # noqa: E402
else:
    from repro_torch.bench import kv_swap

TIER_ARGS = ["--policy", "static", "--pool-tokens", "8192", "--paged"]
MODES = {"off": [], "on": ["--prefix-cache"]}


def waves(vocab: int, seed: int = 0) -> List[List[List[int]]]:
    """The shared-system-prompt stream grouped into kv_swap.WAVE_S-second
    waves: multi-turn follow-ups (120 s after their parent) land in later
    waves, after their parent's blocks were registered."""
    from repro_torch.serving.workload import shared_prefix

    out: List[List[List[int]]] = []
    for t, toks, _ in shared_prefix(
            rate=2.0, n=16, vocab_size=vocab, n_system_prompts=4,
            system_len=256, user_len=(16, 64), mean_out=32.0,
            p_followup=0.7, max_turns=3, turn_gap_s=120.0, seed=seed):
        k = int(t // kv_swap.WAVE_S)
        while len(out) <= k:
            out.append([])
        out[k].append(list(toks))
    return [w for w in out if w]


def prefix_argv(mode: str, base: List[str]) -> List[str]:
    """The flags of one mode on top of `base` (chip_smoke.SERVE_ARGS)."""
    return base + TIER_ARGS + MODES[mode]


def main(argv=None) -> int:
    return kv_swap.main(argv, modes=MODES, make_waves=waves,
                        make_argv=prefix_argv, name="prefix_caching")


if __name__ == "__main__":
    sys.exit(main())
