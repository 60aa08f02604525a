"""Training CLI of the port: any --arch, on the GPU by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \
        --steps 30

The flags of the JAX package's `launch/train.py`, with the same names and
defaults, plus `--device` (default cuda; without a GPU it raises unless
`--device cpu` is given). The reduced variant trains in fp32, the full
one in bf16 with fp32 moments.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.config.base import TrainConfig
from repro_torch.config.registry import get_config, list_archs
from repro_torch.models.model import build_model
from repro_torch.training.train_loop import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=list_archs())
    ap.add_argument("--variant", default="reduced",
                    choices=["reduced", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, args.variant)
    model = build_model(cfg, dtype=torch.float32 if args.variant == "reduced"
                        else torch.bfloat16, device=args.device)
    t = TrainConfig(global_batch=args.batch, seq_len=args.seq,
                    steps=args.steps, lr=args.lr,
                    warmup_steps=max(args.steps // 10, 1), log_every=10)
    res = train(model, t, checkpoint_path=args.ckpt or None)
    print(f"final loss {res['losses'][-1]:.4f} "
          f"({res['tokens_per_s']:.0f} tok/s)")


if __name__ == "__main__":
    main()
