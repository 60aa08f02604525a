"""Where a training step's device time goes on one GPU: chip_smoke.py's
full-width training runs (granite-3-8b on 16 of its 40 layers, mamba2-2.7b
whole; bf16, fp32 moments, remat, B 8, T 256), one step at a time.

    python src/repro_torch/bench/train_step.py [--arch granite-3-8b]
        [--layers 16] [--steps 4]

After two warm-up steps, each timed step runs its two halves apart under
CUDA events: the loss and its gradient (`train_loop.value_and_grad`: the
forward, remat's recomputation, the backward) and the AdamW update. The
last step runs again under `torch.profiler`. Prints the card's name and
power limit, then one JSON line: the medians of the step and of each
half in ms, the profiled step's CUDA kernel time by class of kernel
(GEMM, softmax, reductions, copies and indexing, elementwise, other) and
its top 15 kernels, and peak memory in GB.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]


#: kernel classes by words of the kernel's name, first match wins
KERNEL_CLASSES = (("gemm", ("gemm", "nvjet", "xmma", "cutlass", "wgmma")),
                  ("softmax", ("softmax",)),
                  ("reduce", ("reduce",)),
                  ("copy_index", ("copy", "cat", "index", "scatter",
                                  "gather", "memcpy", "memset")),
                  ("elementwise", ("elementwise",)))


def _device_us(e) -> float:
    return getattr(e, "device_time_total", None) \
        or getattr(e, "cuda_time_total", 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first N layers (0: all)")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_step: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.config.base import TrainConfig
    from repro_torch.config.registry import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training.data import MarkovData
    from repro_torch.training.optimizer import adamw_init, adamw_update
    from repro_torch.training.train_loop import (to_device, trainable,
                                                 value_and_grad)

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    cfg = get_config(args.arch, "full")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    tcfg = TrainConfig(steps=2 + args.steps + 1, lr=3e-4, warmup_steps=2)
    model = build_model(cfg, torch.bfloat16, "cuda")
    params = trainable(model.init(0))
    opt = adamw_init(params)
    it = MarkovData(cfg, tcfg).batches()

    def step():
        batch = to_device(next(it), "cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        _, _, grads = value_and_grad(model, params, batch, tcfg.remat)
        ev[1].record()
        adamw_update(params, grads, opt, tcfg)
        ev[2].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    for _ in range(2):
        step()
    torch.cuda.reset_peak_memory_stats()
    times = [step() for _ in range(args.steps)]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()

    from torch.autograd import DeviceType
    kernels = sorted(((e.key, _device_us(e) / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda r: -r[1])
    by_class = {}
    for name, ms, _ in kernels:
        c = next((c for c, words in KERNEL_CLASSES
                  if any(w in name.lower() for w in words)), "other")
        by_class[c] = by_class.get(c, 0.0) + ms
    print(json.dumps(dict(
        arch=args.arch, layers=cfg.num_layers, batch=tcfg.global_batch,
        seq=tcfg.seq_len,
        step_ms=statistics.median(a + b for a, b in times),
        grad_ms=statistics.median(a for a, _ in times),
        adamw_ms=statistics.median(b for _, b in times),
        profiled_kernel_ms=sum(ms for _, ms, _ in kernels),
        kernel_ms_by_class=by_class,
        top_kernels=[dict(kernel=k[:120], ms=ms, calls=n)
                     for k, ms, n in kernels[:15]],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
