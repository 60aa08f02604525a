"""Kernel-only sweep of the Mamba2 SSD intra-chunk term (`ops.ssd_intra`)
on one GPU, at mamba2-2.7b's widths (H 80, P 64, N 128).

    python src/repro_torch/bench/ssd_sweep.py [--src DIR] [--q 1 7 16 64 256]

Cases: Q in --q, B in {1, 2}, nc in {1, 2}, fp32, with chip_smoke's
mamba2-like inputs. For each case: device ms of one call
(`chip_smoke.time_ms`: CUDA events, median of 30, L2 flushed), host
microseconds a call (`chip_smoke.host_us`: 1000 back-to-back calls), the
number of device kernels one call runs (from `torch.profiler`), and the
max abs error against the fp32 plain version as a share of max|plain|.
With `--src`, `repro_torch` is imported from that source tree (an unpacked
earlier commit, say), so two versions can be compared in one run on one
card. The first line is the card's name and power limit; then one JSON
object a case.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
H, P, N = 80, 64, 128


def ssd_inputs(B, nc, Q, H, P, N, g, dev):
    """chip_smoke's mamba2-like inputs: dt in [1e-3, 1e-1], A = -1 .. -H,
    so the decays lie in (0, 1]."""
    dt = torch.rand((B, nc, Q, H), generator=g, device=dev) * 0.099 + 0.001
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    xdt = torch.randn((B, nc, Q, H, P), generator=g, device=dev) \
        * dt[..., None]
    cum_a = torch.cumsum(dt * A, dim=2)
    Br = torch.randn((B, nc, Q, N), generator=g, device=dev)
    Cr = torch.randn((B, nc, Q, N), generator=g, device=dev)
    return xdt, cum_a, Br, Cr


def device_kernels(fn, calls: int = 10):
    """The device kernels of `calls` calls of `fn` (after one warm-up
    call), recorded by `torch.profiler`: a list of kernel names. (The
    profiler now and then misses one kernel record, so a caller divides by
    `calls` and rounds, rather than profiling a single call.)"""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="source tree to import repro_torch from")
    ap.add_argument("--q", type=int, nargs="+", default=[1, 7, 16, 64, 256])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import ops, ref

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # the first event timing of a process reads high: one throwaway first
    chip_smoke.time_ms(lambda: flush[:4].zero_(), flush)
    g = torch.Generator(device=dev).manual_seed(0)
    for Q in args.q:
        for B in (1, 2):
            for nc in (1, 2):
                a = ssd_inputs(B, nc, Q, H, P, N, g, dev)
                fn = lambda a=a: ops.ssd_intra(*a)  # noqa: E731
                got, want = fn(), ref.ssd_intra_ref(*a)
                err = max(float((x - w).abs().max() / w.abs().max())
                          for x, w in zip(got, want))
                print(json.dumps(dict(
                    src=args.src, B=B, nc=nc, Q=Q, H=H, P=P, N=N,
                    ms=chip_smoke.time_ms(fn, flush),
                    host_us=chip_smoke.host_us(fn),
                    kernels_a_call=round(len(device_kernels(fn)) / 10),
                    err_share_of_max=err)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
