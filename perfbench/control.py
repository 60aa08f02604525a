"""The readings a cell's correctness limit is set from, on the card.

    python3 perfbench/control.py --workload granite-chat --seconds 20 \
        --seeds 1 2 3 --control-seeds 1 2 3

Runs the cell on each seed at its own load (a shorter window suffices to
finish and compare as many requests as a run does) and prints, a line a
seed, the widest gap of the served tokens (the lower reading) and, on the
control seeds, the run judged with the control in the program's place:
the widest gap of the tokens the float8 (W8A8) reference puts first on the
same requests (the upper reading) and its `correct`, which has to be
false. The limit in `workloads/<cell>.json` lies between the largest lower
and the smallest upper reading (`PERF.md` gives both).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from perfbench.cell import run_cell
    from perfbench.registry import Bench

    bench = Bench()
    for seed in args.seeds:
        ctl = seed in args.control_seeds
        out = run_cell(bench, args.workload, seed, args.seconds, False,
                       args.device, control=ctl)
        gap = out["check"]["widest_gap"]["value"]
        print(json.dumps({
            "seed": seed,
            "program_widest_gap": out["program_widest_gap"] if ctl else gap,
            "control_widest_gap": gap if ctl else None,
            # with the control in the program's place, `correct` is the
            # control's and has to come out false
            "correct": out["correct"], "control": ctl,
            "tokens": out["served_tokens_compared"],
            "limit": out["check"]["widest_gap"]["limit"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
