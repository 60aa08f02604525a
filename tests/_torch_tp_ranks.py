"""Rank processes of tests/test_torch_tp_serving.py.

    PYTHONPATH=src python tests/_torch_tp_ranks.py

Runs the port's tensor-parallel engine (reduced granite-3-8b, fp32, the
CPU, gloo) in 2 ranks on a (1, 2) mesh and then in 4 ranks on a (2, 2)
mesh, through `launch.mesh.spawn_ranks`, and prints one line
`RESULT<json>`: per scenario, rank 0's tokens and counters and whether
every rank's tokens, batch sizes and block tables agreed step for step.
The weights are `numpy_params()`, which the test also hands to the JAX
engine.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.launch import serve as port_serve
from repro_torch.launch.mesh import make_serving_group, spawn_ranks
from repro_torch.models.backbone import init_params
from repro_torch.models.model import build_model
from repro_torch.params import from_jax_params
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import Engine

ARCH = "granite-3-8b"
MAX_CONTEXT = 96
LENS = [28, 34, 22, 30, 26]
TIGHT = [40, 44, 38, 46]
COUNTERS = ("admitted", "preemptions", "oom_events", "rejected",
            "swap_outs", "swap_ins", "swap_out_bytes", "swap_in_bytes",
            "decode_steps", "mean_batch", "prefill_tokens", "finished",
            "sla_requests_met", "goodput_tokens", "copy_rows", "model_shards",
            "pool_tokens")


def numpy_params(seed: int = 0):
    """Reduced granite's weights drawn with numpy from `seed`, as a nested
    dict of fp32 arrays in the layout both packages read: matrices at
    1/sqrt(fan_in), the embedding at 1/sqrt(d), norm weights at 0.1."""
    cfg = get_config(ARCH, "reduced")
    rng = np.random.RandomState(seed)

    def fill(tree, prefix=""):
        out = {}
        for k in sorted(tree):
            v, name = tree[k], prefix + k
            if isinstance(v, dict):
                out[k] = fill(v, name + "/")
                continue
            shape = tuple(v.shape)
            scale = 0.1 if name.split("/")[-1].startswith("ln") \
                else 1 / np.sqrt(shape[-1] if name == "embed" else shape[-2])
            out[k] = (rng.standard_normal(shape) * scale).astype(np.float32)
        return out

    return fill(init_params(cfg, 0, torch.float32, "cpu"))


def prompts_of(lens, seed, vocab):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, size=n))) for n in lens]


def serve_cfg(mesh, paged=True, pool=256, swap=0, preempt="auto",
              policy="static", sla_ms=0.0, alpha=16, delta=4):
    return ServeConfig(policy=policy, b_max=4, max_new_tokens=8,
                       alpha=alpha, delta=delta,
                       kv_pool_tokens=pool, block_size=16,
                       chunked_prefill=True, chunk_budget_tokens=24,
                       n_prefill_lanes=2, paged_kv=paged,
                       swap_space_blocks=swap, preempt=preempt,
                       d_sla_ms=sla_ms, mesh_shape=mesh)


def everyone(group, value):
    """`value` of every rank, in rank order (on the control group)."""
    out = [None] * group.world
    dist.all_gather_object(out, value, group=group.control)
    return out


def report(eng, hs, group, steps):
    """Rank 0's record of a run, and whether all ranks ran it alike."""
    s = eng.summary()
    tokens = [h.output_tokens for h in hs]
    same = everyone(group, (tokens, eng.batch_trace, steps))
    return {
        "tokens": tokens,
        "agree": all(x == same[0] for x in same),
        "counters": {k: s[k] for k in COUNTERS},
        "eta": eng.mem.eta,
        "kv_heads": int(eng.cache["k"].shape[-2]),
        "finished": sorted(h.rid for h in hs
                           if h.state.value == "finished" and not h.rejected),
        "rejected": sorted(h.rid for h in hs if h.rejected),
        "sla_met": sorted(h.rid for h in hs if h.sla_met),
        "drained": not (eng.waiting or eng.active or eng.prefilling
                        or eng.swapped or eng._inflight),
    }


def run_engine(model, params, group, serve, lens, max_new, seed):
    eng = Engine(model, params, serve, max_context=MAX_CONTEXT,
                 buckets=(1, 2, 4), prefill_chunk=8, device="cpu")
    hs = [eng.submit(p, max_new_tokens=max_new, arrival_time=0.0)
          for p in prompts_of(lens, seed, model.cfg.vocab_size)]
    steps = []
    while eng.step() and len(steps) < 20_000:
        steps.append({str(r): eng.blocks.table(r)
                      for r in sorted(eng.blocks.block_tables)})
    return report(eng, hs, group, steps)


class _SkewedTime:
    """`time` for the engine module of one rank: its clock runs 10^6 x
    fast from a 10^4 s offset, so every interval, wait and stamp it
    measures disagrees with rank 0's (a CPU step's wait of microseconds
    reads as seconds, far past the SLA)."""

    def __init__(self, real):
        self.real = real

    def perf_counter(self):
        return 1e6 * self.real.perf_counter() + 1e4


def skewed_sla(model, params, group):
    """The `sla` policy, whose batch window (alpha = delta = 1) widens
    under the SLA and narrows over it, with rank 1's clock skewed: the engine agrees rank 0's values, so both
    ranks decide alike (and no collective is left waiting)."""
    if group.rank == 1:
        engine_mod.time = _SkewedTime(time)
    try:
        return run_engine(model, params, group,
                          serve_cfg(group.mesh_shape, policy="sla",
                                    sla_ms=50.0, alpha=1, delta=1),
                          TIGHT, 12, seed=3)
    finally:
        engine_mod.time = time


def cli_depths(group):
    """The CLI's --mesh path in this rank (`build_engine` on the ambient
    group): the memory policy at overlap depth 0 and 2."""
    out = {}
    for depth in (0, 2):
        args = port_serve.build_parser().parse_args(
            ["--device", "cpu", "--paged", "--chunked", "--lanes", "2",
             "--requests", "6", "--pool-tokens", "256", "--policy", "memory",
             "--mesh", ",".join(map(str, group.mesh_shape)),
             "--overlap-depth", str(depth)])
        eng = port_serve.run(args)
        hs = eng.cli_requests
        out[depth] = report(eng, hs, group, [])
    return out


def rank_main(rank, world, mesh):
    torch.set_num_threads(1)
    group = make_serving_group(mesh, "gloo", rank, world)
    cfg = get_config(ARCH, "reduced")
    model = build_model(cfg, torch.float32, "cpu", group=group)
    params = model.shard(from_jax_params(numpy_params()))
    out = {
        "paged": run_engine(model, params, group, serve_cfg(mesh), LENS, 8,
                            seed=0),
        "contiguous": run_engine(model, params, group,
                                 serve_cfg(mesh, paged=False), LENS, 8,
                                 seed=0),
    }
    if mesh == (1, 2):
        out["perchip"] = run_engine(
            model, params, group,
            serve_cfg(mesh, pool=80, swap=24, preempt="swap"), TIGHT, 12,
            seed=2)
        out["skewed_sla"] = skewed_sla(model, params, group)
        out["cli"] = cli_depths(group)
    else:
        out["diff_noswap"] = run_engine(
            model, params, group, serve_cfg(mesh, pool=96, policy="memory"),
            TIGHT, 12, seed=1)
        out["diff_swap"] = run_engine(
            model, params, group,
            serve_cfg(mesh, pool=80, swap=24, preempt="swap"), TIGHT, 12,
            seed=2)
    return out


if __name__ == "__main__":
    res = {}
    for mesh in ((1, 2), (2, 2)):
        t0 = time.perf_counter()
        res[",".join(map(str, mesh))] = spawn_ranks(
            rank_main, mesh[0] * mesh[1], (mesh,), timeout_s=240)
        res[",".join(map(str, mesh))]["seconds"] = time.perf_counter() - t0
    print("RESULT" + json.dumps(res))
