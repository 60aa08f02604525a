"""SLA-constrained serving on the PyTorch port (paper Algorithm 2 + Table
II / Fig 4; the twin of examples/sla_capacity.py).

Sweeps offered load through the port's simulator and reports SLA
attainment + capacity for static vs the combined (min(b_mem, b_SLA))
controller, then runs the combined controller on the real engine (a
reduced model) at the same TBT SLA.

    PYTHONPATH=src python examples/torch_sla_capacity.py [--device cpu]

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

SLA_MS = 50.0


def run(policy: str, qps: float):
    cfg = get_config("granite-3-8b")
    cost = CostModel(cfg, PROFILES["paper-fig3"], c0_ms=28.0, c1_ms=0.225)
    serve = ServeConfig(policy=policy, b_max=256, d_sla_ms=SLA_MS,
                        eps_d_ms=3.0, max_new_tokens=256)
    sim = ServingSimulator(cfg, serve, cost,
                           LengthDist(mean_in=256, mean_out=64), seed=0)
    sim.add_requests(400, arrival_rate=qps)
    return sim.run()


def real_engine(device):
    """The combined controller on a reduced model: the measured TBT of each
    interval feeds Algorithm 2, which holds the batch under the SLA."""
    cfg = get_config("granite-3-8b", "reduced")
    model = build_model(cfg, dtype=torch.float32, device=device)
    serve = ServeConfig(policy="combined", b_max=8, d_sla_ms=SLA_MS,
                        eps_d_ms=3.0, max_new_tokens=16)
    eng = Engine(model, model.init(0), serve, max_context=64,
                 buckets=(1, 2, 4, 8), prefill_chunk=16, device=device)
    rng = np.random.RandomState(0)
    for _ in range(8):
        eng.submit(list(map(int, rng.randint(0, cfg.vocab_size,
                                             size=rng.randint(4, 24)))))
    eng.run()
    s = eng.summary()
    print(f"-- real engine, combined, {device}: "
          f"attain={s['sla_attainment']:5.3f} "
          f"tbt_mean={s['tbt_ms_mean']:6.1f}ms "
          f"mean_batch={s['mean_batch']:4.1f} finished={s['finished']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(f"TBT SLA = {SLA_MS} ms; capacity = max qps with >=90% attainment "
          f"and bounded TTFT")
    for policy in ("static", "combined"):
        cap = 0.0
        print(f"-- {policy}")
        for qps in (1, 2, 4, 6, 8, 12, 16):
            res = run(policy, qps)
            ok = res.sla_attainment >= 0.9 and res.ttft_p90_s <= 30.0
            print(f"   qps={qps:4.1f} attain={res.sla_attainment:5.3f} "
                  f"tbt_mean={res.tbt_ms_mean:6.1f}ms "
                  f"ttft_p90={res.ttft_p90_s:6.1f}s "
                  f"mean_batch={res.mean_batch:6.1f} {'OK' if ok else 'X'}")
            if ok:
                cap = qps
        print(f"   capacity({policy}) = {cap} qps")
    real_engine(args.device)


if __name__ == "__main__":
    main()
