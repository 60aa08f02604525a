"""Static vs dynamic batching head-to-head on the PyTorch port (paper
Table I in miniature; the twin of examples/serve_dynamic.py).

Runs the SAME workload through the vLLM-style static preset and the paper's
memory-aware controller on a deliberately tight KV pool, on a real reduced
model — then at paper scale through the port's calibrated simulator.

    PYTHONPATH=src python examples/torch_serve_dynamic.py [--device cpu]

The real engine runs on the GPU unless --device cpu is given.
"""
import argparse

import numpy as np
import torch

from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.models.model import build_model
from repro_torch.serving.cost_model import CostModel, PROFILES
from repro_torch.serving.engine import Engine
from repro_torch.serving.sim import LengthDist, ServingSimulator


def real_engine_comparison(device):
    cfg = get_config("granite-3-8b", "reduced")
    model = build_model(cfg, dtype=torch.float32, device=device)
    params = model.init(0)
    print(f"== real engine (reduced model, tight 384-token pool, {device}) ==")
    for policy in ("static", "memory"):
        rng = np.random.RandomState(2)
        serve = ServeConfig(policy=policy, b_max=8, max_new_tokens=24,
                            kv_pool_tokens=384, block_size=16)
        eng = Engine(model, params, serve, max_context=64,
                     buckets=(1, 2, 4, 8), prefill_chunk=8, device=device)
        for _ in range(8):
            eng.submit(list(map(int, rng.randint(0, cfg.vocab_size, size=8))),
                       max_new_tokens=24)
        eng.run()
        s = eng.summary()
        print(f"  {policy:8s} tput={s['throughput_tok_s']:8.1f} tok/s "
              f"mean_batch={s['mean_batch']:.1f} preemptions={s['preemptions']}")


def simulator_comparison():
    cfg = get_config("granite-3-8b")   # full 8B dims
    cost = CostModel(cfg, PROFILES["a100x8"])
    print("== simulator (full 8B model, 8xA100-class, 600 requests) ==")
    for policy, b_max in (("static", 256), ("memory", 2048)):
        sim = ServingSimulator(
            cfg, ServeConfig(policy=policy, b_max=b_max, max_new_tokens=512),
            cost, LengthDist(mean_in=128, mean_out=128, fixed=True), seed=0)
        sim.add_requests(600)
        res = sim.run()
        print(f"  {policy:8s} tput={res.throughput_tok_s:9.1f} tok/s "
              f"mean_batch={res.mean_batch:.0f} tbt={res.tbt_ms_mean:.1f}ms")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    real_engine_comparison(args.device)
    simulator_comparison()


if __name__ == "__main__":
    main()
