"""Kernel-only sweep of the RG-LRU recurrence on one GPU, at
recurrentgemma-9b's lru width (W 4096).

    python src/repro_torch/bench/rglru_sweep.py [--src DIR] [--t 1 7 16 64 512]

Entries, for T in --t and B in {1, 2, 8}:

* `scan`: `ops.rglru_scan` (fp32 a, bx, h0), the TPU kernel's function;
* `gated`: `ops.rglru_gated_scan` in bf16 (gate pre-activations, x, and
  chip_smoke's lam, b_a, b_i, h0), the model's recurrence;
* `chain`: the same gated recurrence as the model ran it before the gated
  entry (`chip_smoke.eager_gated_scan`: the gates op by op, then
  `ops.rglru_scan`), in the tree under test.

For each case: device ms of one call (`chip_smoke.time_ms`: CUDA events,
median of 30, L2 flushed), host microseconds a call (`chip_smoke.host_us`:
1000 back-to-back calls), the number of device kernels one call runs
(`ssd_sweep.device_kernels`, from `torch.profiler`), and the max abs error
against the fp32 plain version as a share of max|plain|. With `--src`,
`repro_torch` is imported from that source tree (an unpacked earlier
commit, say; a tree without the gated entry gets no `gated` rows), so two
versions can be compared in one run on one card. The first line is the
card's name and power limit; then one JSON object a case.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
W = 4096


def gated_inputs(B, T, g, dev, dtype=torch.bfloat16):
    """The gated entry's operands at W 4096 (chip_smoke's gated cases too):
    unit-scale gate pre-activations and x in `dtype`, Lambda as the model
    initialises it (a^c in about (0.9, 0.999)), small biases, a unit-scale
    h0."""
    def rn(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    u = torch.rand(W, generator=g, device=dev) * (0.999 ** 2 - 0.81) + 0.81
    lam = torch.log(torch.expm1(-torch.log(u) / 8.0))
    f32 = torch.float32
    return (rn(B, T, W), rn(B, T, W), rn(B, T, W), lam, rn(W, dt=f32) * 0.1,
            rn(W, dt=f32) * 0.1, rn(B, W, dt=f32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="source tree to import repro_torch from")
    ap.add_argument("--t", type=int, nargs="+", default=[1, 7, 16, 64, 512])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rglru_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.bench.ssd_sweep import device_kernels
    from repro_torch.kernels import ops, ref

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # the first event timing of a process reads high: one throwaway first
    chip_smoke.time_ms(lambda: flush[:4].zero_(), flush)
    g = torch.Generator(device=dev).manual_seed(0)
    for T in args.t:
        for B in (1, 2, 8):
            a_ = torch.rand((B, T, W), generator=g, device=dev) * 0.5 + 0.5
            scan = (a_, torch.randn((B, T, W), generator=g, device=dev),
                    torch.randn((B, W), generator=g, device=dev))
            gated = gated_inputs(B, T, g, dev)
            # the fp32 plain version (in any tree): the chain on fp32
            # copies with the plain scan
            plain = chip_smoke.eager_gated_scan(
                *(t.float() for t in gated), scan=ref.rglru_scan_ref)
            entries = [("scan", lambda a=scan: ops.rglru_scan(*a),
                        ref.rglru_scan_ref(*scan)),
                       ("chain",
                        lambda a=gated: chip_smoke.eager_gated_scan(*a),
                        plain)]
            if hasattr(ops, "rglru_gated_scan"):
                entries.insert(1, ("gated",
                                   lambda a=gated: ops.rglru_gated_scan(*a),
                                   plain))
            for entry, fn, want in entries:
                got = fn()
                err = max(float((x.float() - w).abs().max() / w.abs().max())
                          for x, w in zip(got, want))
                print(json.dumps(dict(
                    src=args.src, entry=entry, B=B, T=T, W=W,
                    dtype="fp32" if entry == "scan" else "bf16",
                    ms=chip_smoke.time_ms(fn, flush),
                    host_us=chip_smoke.host_us(fn),
                    kernels_a_call=round(len(device_kernels(fn)) / 10),
                    err_share_of_max=err)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
