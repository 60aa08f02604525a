"""Split-count sweep of the bf16 tensor-core attention kernels on one GPU.

    PYTHONPATH=src python -m repro_torch.bench.split_sweep --splits 1 2 4 8 16

For every bf16 attention case of `chip_smoke.py` (contiguous and paged
decode, contiguous and paged prefill chunks), at the split count
`split.num_splits` picks ("auto") and at each forced count (capped at the
key tiles): the CUDA-event time of the whole call
(`chip_smoke.time_ms`: median of 30, L2 flushed before each) and the
profiler's device time of the split pass and of the combine pass. First
two yardsticks of that timing: a call that does almost nothing (a 4-byte
fill) and a bandwidth-bound one (a bf16 add reading two 16.8 MB tensors).
Prints the card's name and power limit, then one JSON object a line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]


def device_ms(fn, flush, reps: int = 10) -> dict:
    """Mean device time per call of the split pass and the combine pass."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for key, name in (("split_pass_ms", "mma_attention_kernel"),
                          ("combine_ms", "mma_combine_kernel")):
            if name in e.key:
                out[key] = e.device_time_total / e.count / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", type=int, nargs="*", default=[1, 2, 4, 8, 16])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("split_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build, split

    _build.build_all()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    a = torch.randn((8, 1024, 8, 128), device=dev).bfloat16()
    b, c = torch.randn_like(a), torch.empty_like(a)
    for what, fn in (("4-byte fill", lambda: flush[:4].zero_()),
                     ("bf16 add, 2 x 16.8 MB in", lambda: torch.add(
                         a, b, out=c))):
        print(json.dumps({"yardstick": what,
                          "ms": chip_smoke.time_ms(fn, flush)}), flush=True)
    cases = [(name, label, kern) for name, label, kern, *_ in
             chip_smoke.kernel_cases(dev)
             if name in ("decode_attention", "paged_decode_attention",
                         "flash_attention", "paged_flash_attention")]
    auto = split.num_splits
    try:
        for force in [None] + args.splits:
            split.num_splits = auto if force is None else (
                lambda B, KV, rt, kt, sms, f=force: min(f, kt))
            for name, label, kern in cases:
                print(json.dumps(dict(
                    kernel=name, case=label, splits=force or "auto",
                    ms=chip_smoke.time_ms(kern, flush),
                    **device_ms(kern, flush))), flush=True)
    finally:
        split.num_splits = auto
    return 0


if __name__ == "__main__":
    sys.exit(main())
