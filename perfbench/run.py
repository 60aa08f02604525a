"""Run one cell of the benchmark on the card this process starts on.

    python3 perfbench/run.py --workload granite-chat --seed 7 --seconds 30 \
        --trace 0

From the root of a checkout. Prints the run's result as one JSON object,
the last line of standard output, and each number compared beside its
limit as the last lines of standard error. Exits non-zero and prints no
result without a CUDA card (or with fewer than the cell asks for), or if
JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.cell import run_cell
    from perfbench.guard import barred_modules
    from perfbench.registry import Bench

    bench = Bench()
    cell = bench.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        print(f"perfbench: cell {args.workload} needs {cell['chips']} CUDA "
              f"card(s), this machine has {have}", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START)
    found = barred_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
