"""Host and device time of the serving interval on one GPU: one serve run
of `chip_smoke.py`'s configuration (its flags and prompts; granite-3-8b
contiguous by default) through `repro_torch.launch.serve.run`.

    python src/repro_torch/bench/serve_step.py [--src DIR] [--arch A]
        [--paged] [--eager] [--overlap-depth K]

With `--src`, `repro_torch` is imported from that source tree (an unpacked
earlier commit, say), so two versions can be compared in one call on one
card, each in a process of its own. `--eager` runs the steps eagerly
(`cuda_graphs=False`); a tree without CUDA graphs always does.
`--overlap-depth K` serves with K intervals dispatched ahead (DESIGN §14;
default 0, the synchronous loop), so the depth-0 and depth-2 runs of one
tree can be compared in one call. Prints the
card's name and power limit, then one JSON line: tokens/s, TBT mean and
p95 (each tree's own TBT sample), `step_host_s_mean`,
`step_device_s_mean`, their sum (the interval's wall time), the host mean
without the seconds spent capturing graphs at first use, decode steps,
the graph counts where the tree has them, and a hash of every request's
output tokens (equal across trees when they serve the same tokens).
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="source tree to import repro_torch from")
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--overlap-depth", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.serving.engine import Engine

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    flags = serve.build_parser().parse_args(
        chip_smoke.SERVE_ARGS + ["--arch", args.arch]
        + (["--paged"] if args.paged else [])
        + (["--overlap-depth", str(args.overlap_depth)]
           if args.overlap_depth else []))
    prompts = chip_smoke.serve_prompts(args.arch)
    # the requests (for their tokens) and the capture seconds of warmup
    handles, warm = [], {}
    submit, warmup = Engine.submit, getattr(Engine, "warmup", None)

    def submit_kept(self, *a, **k):
        handles.append(submit(self, *a, **k))
        return handles[-1]

    def warmup_timed(self):
        warmup(self)
        warm["capture_s"] = self.graphs.capture_s

    Engine.submit = submit_kept
    if warmup is not None:
        Engine.warmup = warmup_timed
    graphs = "cuda_graphs" in inspect.signature(serve.run).parameters
    kw = {"cuda_graphs": False} if graphs and args.eager else {}
    t0 = time.perf_counter()
    eng = serve.run(flags, prompts, **kw)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    s = eng.summary()
    st = eng.graphs.stats() if graphs else None
    n = len(eng.step_host_trace)
    caught = st["capture_s"] - warm.get("capture_s", 0.0) if st else 0.0
    tokens = json.dumps([h.output_tokens for h in handles])
    src = Path(args.src).resolve()
    out = dict(
        src=str(src.relative_to(ROOT)) if src.is_relative_to(ROOT)
        else str(src),
        arch=args.arch, layout="paged" if args.paged else "contiguous",
        overlap_depth=args.overlap_depth,
        graphs=bool(graphs and eng.graphs.enabled), run_s=run_s,
        intervals=n,
        **{k: s[k] for k in ("throughput_tok_s", "tbt_ms_mean", "tbt_ms_p95",
                             "step_host_s_mean", "step_device_s_mean",
                             "decode_steps", "mean_batch", "finished",
                             "ttft_mean_s")},
        interval_s_mean=s["step_host_s_mean"] + s["step_device_s_mean"],
        step_host_s_mean_without_captures=(sum(eng.step_host_trace)
                                           - caught) / max(n, 1),
        graph_stats=st,
        tokens_sha256=hashlib.sha256(tokens.encode()).hexdigest()[:16])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
