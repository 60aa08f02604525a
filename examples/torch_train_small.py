"""End-to-end training of the port: a ~100M-parameter dense model on the
synthetic Markov data, with a checkpoint at the end; the twin of
examples/train_small.py. Runs on the GPU unless asked for the CPU.

    PYTHONPATH=src python examples/torch_train_small.py [--steps 200]
    PYTHONPATH=src python examples/torch_train_small.py --device cpu \
        --steps 3 --batch 2 --seq 32
"""
import argparse

import torch

from repro_torch.config.base import ArchFamily, ModelConfig, TrainConfig
from repro_torch.models.model import build_model
from repro_torch.training.train_loop import train


def model_100m() -> ModelConfig:
    # ~100M params: 12L, d=512, 8 heads, GQA kv=4, SwiGLU 3x512x1536
    return ModelConfig(
        name="repro-100m", family=ArchFamily.DENSE, num_layers=12,
        d_model=512, num_heads=8, num_kv_heads=4, d_ff=1536,
        vocab_size=32768, source="examples/torch_train_small.py")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="build/repro_torch_100m.npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    args = ap.parse_args()

    cfg = model_100m()
    model = build_model(cfg, dtype=torch.float32, device=args.device)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    t = TrainConfig(global_batch=args.batch, seq_len=args.seq,
                    steps=args.steps, lr=3e-3,
                    warmup_steps=min(20, max(args.steps // 10, 1)),
                    log_every=10)
    res = train(model, t, checkpoint_path=args.ckpt)
    print(f"final loss {res['losses'][-1]:.4f}  "
          f"({res['tokens_per_s']:.0f} tok/s); checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
