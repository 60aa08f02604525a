"""Host and device cost of one RMSNorm launch on one GPU, at the decode
step's shape (8 x 4096, bf16) and a long prefill's (4096 x 4096).

    python src/repro_torch/bench/norm_host.py [--src DIR]

For `ops.rmsnorm`, and `ops.add_rmsnorm` where the package has it: host
microseconds per launch (`chip_smoke.host_us`: wall time of 1000
back-to-back launches after warm-up, one synchronize at the end) and the
device time of one call (`chip_smoke.time_ms`: CUDA events, median of 30,
L2 flushed). With `--src`, `repro_torch` is imported from that source
tree (an unpacked earlier commit, say), so two versions of the kernel can
be compared in one run on one card. Beside them, a yardstick of the same
timing: a bf16 copy moving the norm's bytes (rows x d in, rows x d out).
Where the package has the CUDA
kernel (`kernels/csrc/rmsnorm.cu`), also the host microseconds of each
step of its launch at 8 x 4096, and of one eager PyTorch op for scale.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="source tree to import repro_torch from")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("norm_host: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import ops

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # the first event timing of a process reads high (0.023-0.055 ms for a
    # ~0.006 ms call, H100): one throwaway timing first
    chip_smoke.time_ms(lambda: flush[:4].zero_(), flush)
    g = torch.Generator(device=dev).manual_seed(0)
    d = 4096
    for rows in (8, 4096):
        x, y = (torch.randn((rows, d), generator=g, device=dev).bfloat16()
                for _ in range(2))
        w = (torch.randn((d,), generator=g, device=dev) * 0.1).bfloat16()
        fns = {"rmsnorm": lambda: ops.rmsnorm(x, w)}
        if hasattr(ops, "add_rmsnorm"):
            fns["add_rmsnorm"] = lambda: ops.add_rmsnorm(x, y, w)
        for name, fn in fns.items():
            print(json.dumps(dict(
                src=args.src, kernel=name, rows=rows, d=d,
                host_us=chip_smoke.host_us(fn),
                ms=chip_smoke.time_ms(fn, flush),
                launches=ops.LAUNCHES[name])), flush=True)
        out = torch.empty_like(x)
        print(json.dumps(dict(
            yardstick="bf16 copy, rows x d in and out", rows=rows, d=d,
            ms=chip_smoke.time_ms(lambda: out.copy_(x), flush))), flush=True)
    if hasattr(ops, "add_rmsnorm"):
        breakdown(chip_smoke.host_us, dev)
    return 0


def breakdown(host_us, dev) -> None:
    """Host microseconds of each step of one `ops.rmsnorm` launch at
    8 x 4096 bf16."""
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ops

    x, y = (torch.randn((8, 4096), device=dev).bfloat16() for _ in range(2))
    w = torch.zeros(4096, device=dev).bfloat16()
    out = torch.empty_like(x)
    lib = _build.library("rmsnorm")
    ptrs = _build.cuda_args(x, w, out, dtype=x.dtype)
    strm = _build.stream()
    steps = {
        "ops.rmsnorm": lambda: ops.rmsnorm(x, w),
        "ops.add_rmsnorm": lambda: ops.add_rmsnorm(x, y, w),
        "torch.empty_like": lambda: torch.empty_like(x),
        "_build.cuda_args, 3 tensors": lambda: _build.cuda_args(
            x, w, out, dtype=x.dtype),
        "_build.stream": _build.stream,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "ctypes call, arguments ready": lambda: lib.rmsnorm(
            1, *ptrs, 8, 4096, 1e-6, strm),
        "x.reshape(-1, d).contiguous()":
            lambda: x.reshape(-1, 4096).contiguous(),
        "eager x + y": lambda: x + y,
        "F.rms_norm": lambda: F.rms_norm(x, (4096,), weight=w, eps=1e-6),
    }
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        steps["torch._C._cuda_getCurrentRawStream"] = lambda: raw(0)
    for step, fn in steps.items():
        print(json.dumps({"step": step, "host_us": host_us(fn)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
