"""Rank processes of tests/test_torch_tp_serving.py.

    PYTHONPATH=src python tests/_torch_tp_ranks.py

Runs the port's tensor-parallel engine (fp32, the CPU, gloo) in 2 ranks on
a (1, 2) mesh, then in 4 ranks on a (2, 2) mesh and in 4 on a (1, 4) mesh,
through `launch.mesh.spawn_ranks`, and prints one line `RESULT<json>`: per
scenario, rank 0's tokens and counters and whether every rank's tokens,
batch sizes and block tables agreed step for step. Reduced granite-3-8b
serves the scenarios of the dense family (at (1, 4) only its two layouts:
its 2 kv-heads take the head_dim fallback there); the MoE, VLM, enc-dec,
SSM and hybrid families (`FAMILIES`: reduced qwen2-moe-a2.7b,
kimi-k2-1t-a32b, llama-3.2-vision-90b, seamless-m4t-medium, a qwen2-moe
of 5 experts, which the model axis does not divide, mamba2-2.7b and
recurrentgemma-9b, whose single kv-head takes the fallback) serve
`FAM_LENS` in both layouts on the (1, 2) and (2, 2) meshes, with extras
where the family takes them. The weights are `numpy_params(cfg)`, which
the test also hands to the JAX engine.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.graph_audit import ALLREDUCE, GATHER, OpTrace
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
#: the families served beside granite, by name (`family_config`); E5 is
#: reduced qwen2-moe with 5 experts, whose stacks replicate at m = 2
E5 = "qwen2-moe-e5"
FAMILIES = ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "llama-3.2-vision-90b",
            "seamless-m4t-medium", E5, "mamba2-2.7b", "recurrentgemma-9b")
#: the meshes, and the one whose model axis of 4 takes granite's head_dim
#: fallback
MESHES = ((1, 2), (2, 2), (1, 4))
FALLBACK = (1, 4)
FAM_LENS = [28, 34, 22, 30]
FAM_SEED = 4
#: cross keys a request of the VLM and enc-dec runs
ENC_LEN = 16
COUNTERS = ("admitted", "preemptions", "oom_events", "rejected",
            "swap_outs", "swap_ins", "swap_out_bytes", "swap_in_bytes",
            "decode_steps", "mean_batch", "prefill_tokens", "finished",
            "sla_requests_met", "goodput_tokens", "copy_rows", "model_shards",
            "pool_tokens")


def family_config(name: str, get=get_config):
    """The reduced config of `name` (a registry arch, or E5) from `get`,
    this package's `get_config` or the JAX package's."""
    if name == E5:
        base = get("qwen2-moe-a2.7b", "reduced")
        return dataclasses.replace(base, name=name, moe=dataclasses.replace(
            base.moe, num_experts=5))
    return get(name, "reduced")


def numpy_params(cfg=None, seed: int = 0):
    """Weights of `cfg` (default reduced granite) drawn with numpy from
    `seed`, as a nested dict of fp32 arrays in the layout both packages
    read: matrices at 1/sqrt(fan_in), the embedding at 1/sqrt(d), norm
    weights at 0.1, the cross layers' gates at 0.5 (at 0 the VLM's cross
    layers would add nothing)."""
    cfg = cfg or get_config(ARCH, "reduced")
    rng = np.random.RandomState(seed)

    def fill(tree, prefix=""):
        out = {}
        for k in sorted(tree):
            v, name = tree[k], prefix + k
            if isinstance(v, dict):
                out[k] = fill(v, name + "/")
                continue
            shape = tuple(v.shape)
            if k == "gate":
                out[k] = np.full(shape, 0.5, np.float32)
                continue
            scale = 0.1 if k.startswith("ln") \
                else 1 / np.sqrt(shape[-1] if name == "embed" else shape[-2])
            out[k] = (rng.standard_normal(shape) * scale).astype(np.float32)
        return out

    return fill(init_params(cfg, 0, torch.float32, "cpu"))


def extras_of(cfg, n: int, seed: int):
    """n requests' extras ((1, ENC_LEN, d) fp32 arrays) for a VLM or
    enc-dec config, drawn from `seed`, the same on every rank; None for
    the other families."""
    if cfg.family.value not in ("vlm", "encdec"):
        return [None] * n
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((1, ENC_LEN, cfg.d_model)).astype(np.float32)
            for _ in range(n)]


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
        **({"kv_heads": int(eng.cache["k"].shape[-2]),
            "kv_dim": int(eng.cache["k"].shape[-1])}
           if "k" in eng.cache else {}),
        **({"cross_heads": int(eng.cache["cross_k"].shape[-2])}
           if "cross_k" in eng.cache else {}),
        "finished": sorted(h.rid for h in hs
                           if h.state.value == "finished" and not h.rejected),
        "rejected": sorted(h.rid for h in hs if h.rejected),
        "sla_met": sorted(h.rid for h in hs if h.sla_met),
        "drained": not (eng.waiting or eng.active or eng.prefilling
                        or eng.swapped or eng._inflight),
    }


def run_engine(model, params, group, serve, lens, max_new, seed):
    cross = extras_of(model.cfg, len(lens), seed + 100)
    key = "enc_frames" if model.cfg.family.value == "encdec" else "images"
    eng = Engine(model, params, serve, max_context=MAX_CONTEXT,
                 buckets=(1, 2, 4), prefill_chunk=8, device="cpu",
                 enc_len=ENC_LEN if cross[0] is not None else 0)
    hs = [eng.submit(p, max_new_tokens=max_new, arrival_time=0.0,
                     extras=None if x is None else {key: x})
          for p, x in zip(prompts_of(lens, seed, model.cfg.vocab_size),
                          cross)]
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


class StoppedClock:
    """`time` for the engine module: its clock stands at `at` (seconds of
    the real clock), so every stamp reads the same value and a TTFT is
    the stamps' lag alone, whatever the load on the host."""

    def __init__(self, at: float):
        self.at = at

    def perf_counter(self):
        return self.at


#: the idle gap of the clock scenario, seconds
GAP_S = 5.0


def clock_after_idle(model, params, group):
    """The clock after an idle gap: two requests served and drained, then
    the engine's clock stopped GAP_S ahead (idle time that passed) and one
    more request served, every stamp from the engine's own clock. Returns
    the last request's TTFT, every rank's stamps, and the control-group
    broadcasts of the submit and of each busy step."""
    eng = Engine(model, params, serve_cfg(group.mesh_shape),
                 max_context=MAX_CONTEXT, buckets=(1, 2, 4), prefill_chunk=8,
                 device="cpu")
    a, b, c = prompts_of([20, 24, 18], 7, model.cfg.vocab_size)
    hs = [eng.submit(a, max_new_tokens=4), eng.submit(b, max_new_tokens=4)]
    eng.run()
    agree, calls = group.agree, []

    def counted(values):
        calls.append(len(values))
        return agree(values)

    group.agree = counted
    engine_mod.time = StoppedClock(time.perf_counter() + GAP_S)
    try:
        hs.append(eng.submit(c, max_new_tokens=4))
        per_step, n = [len(calls)], len(calls)
        while eng.step():
            per_step.append(len(calls) - n)
            n = len(calls)
    finally:
        engine_mod.time = time
        del group.agree
    last = hs[-1]
    stamps = [(h.arrival_time, h.first_token_time, h.finish_time)
              for h in hs]
    return {"ttft": last.first_token_time - last.arrival_time,
            "stamps_agree": len(set(map(tuple, everyone(group, stamps))))
            == 1,
            "submit_broadcasts": per_step[0],
            "busy_step_broadcasts": per_step[1:],
            "tokens": [h.output_tokens for h in hs]}


def families(group, mesh):
    """The MoE, VLM and enc-dec families (`FAMILIES`) in both layouts."""
    out = {}
    for name in FAMILIES:
        cfg = family_config(name)
        model = build_model(cfg, torch.float32, "cpu", group=group)
        params = model.shard(from_jax_params(numpy_params(cfg)))
        for paged in (True, False):
            r = run_engine(model, params, group, serve_cfg(mesh, paged=paged),
                           FAM_LENS, 8, seed=FAM_SEED)
            out[f"{name} {'paged' if paged else 'contiguous'}"] = r
        out[f"{name} paged"]["allreduces"] = forward_allreduces(model,
                                                                params)
    return out


def forward_allreduces(model, params):
    """The all-reduces of one first chunk (with extras where the family
    takes them) and of one decode step, and their gathers, traced
    (`graph_audit.OpTrace`)."""
    cfg = model.local_cfg
    cross = extras_of(cfg, 1, 0)[0]
    key = "enc_frames" if cfg.family.value == "encdec" else "images"
    extras = None if cross is None else {key: torch.from_numpy(cross)}
    cache = model.init_cache(1, 16, enc_len=ENC_LEN if extras else 0,
                             prefill_chunk=8)
    tokens = torch.ones((1, 8), dtype=torch.int64)
    out = {}
    with OpTrace() as tr:
        model.prefill(params, tokens, torch.arange(8, dtype=torch.int32)[None],
                      cache, extras=extras, last_only=True)
    out["prefill"] = tr.collectives[ALLREDUCE]
    out["prefill_gathers"] = tr.collectives[GATHER]
    with OpTrace() as tr:
        model.decode_step(params, tokens[:, 0], torch.tensor(
            [8], dtype=torch.int32), cache)
    out["decode"] = tr.collectives[ALLREDUCE]
    out["decode_gathers"] = tr.collectives[GATHER]
    return out


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
    if mesh == FALLBACK:
        return {layout: run_engine(model, params, group,
                                   serve_cfg(mesh, paged=paged), LENS, 8,
                                   seed=0)
                for layout, paged in (("paged", True),
                                      ("contiguous", False))}
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
        out["clock"] = clock_after_idle(model, params, group)
        out["cli"] = cli_depths(group)
    else:
        out["diff_noswap"] = run_engine(
            model, params, group, serve_cfg(mesh, pool=96, policy="memory"),
            TIGHT, 12, seed=1)
        out["diff_swap"] = run_engine(
            model, params, group,
            serve_cfg(mesh, pool=80, swap=24, preempt="swap"), TIGHT, 12,
            seed=2)
    out["families"] = families(group, mesh)
    return out


if __name__ == "__main__":
    res = {}
    for mesh in MESHES:
        t0 = time.perf_counter()
        res[",".join(map(str, mesh))] = spawn_ranks(
            rank_main, mesh[0] * mesh[1], (mesh,), timeout_s=240)
        res[",".join(map(str, mesh))]["seconds"] = time.perf_counter() - t0
    print("RESULT" + json.dumps(res))
