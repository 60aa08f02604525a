"""Quickstart on the PyTorch port: serve a reduced model with memory-aware
dynamic batching (the twin of examples/quickstart.py).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the GPU unless --device cpu is given.
"""
import argparse

import numpy as np
import torch

from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("granite-3-8b", "reduced")
    model = build_model(cfg, dtype=torch.float32, device=args.device)
    params = model.init(0)

    serve = ServeConfig(policy="memory",   # paper Algorithm 1
                        b_max=16, max_new_tokens=16, kv_pool_tokens=4096)
    eng = Engine(model, params, serve, max_context=128,
                 buckets=(1, 2, 4, 8, 16), prefill_chunk=16,
                 device=args.device)

    rng = np.random.RandomState(0)
    handles = [eng.submit(list(map(int, rng.randint(0, cfg.vocab_size,
                                                    size=rng.randint(4, 24)))))
               for _ in range(10)]
    eng.run()

    for h in handles[:3]:
        print(f"req {h.rid}: prompt[{h.prompt_len}] -> {h.output_tokens}")
    print("summary:", {k: round(v, 2) for k, v in eng.summary().items()})


if __name__ == "__main__":
    main()
