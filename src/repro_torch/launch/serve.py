"""Serving CLI of the port: the continuous-batching engine on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --variant full \
        --policy memory --requests 12 --chunked --lanes 2

Every flag of the JAX package's `launch/serve.py`, with the same names and
defaults, plus `--device` (default cuda; `--device cpu` runs the plain
PyTorch path). Flags of features the port has not reached yet (trace
replay, prefix sharing, the swap tier, async overlap, mesh serving) raise
NotImplementedError when set away from their defaults.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config, list_archs
from repro_torch.serving.cost_model import PROFILES


def parse_buckets(spec: str):
    """"1,2,4" -> (1, 2, 4): decode batch bucket sizes."""
    try:
        shape = tuple(int(p) for p in spec.split(",") if p)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--batch-buckets wants comma-separated ints, got {spec!r}")
    if any(s < 1 for s in shape):
        raise argparse.ArgumentTypeError(
            f"--batch-buckets sizes must be >= 1, got {spec!r}")
    return shape


def parse_mesh(spec: str):
    """"2,2" / "2x2" -> (2, 2); last axis is "model" (DESIGN §12)."""
    parts = [p for p in spec.replace("x", ",").split(",") if p]
    shape = tuple(int(p) for p in parts)
    if not shape or any(s < 1 for s in shape) or len(shape) > 3:
        raise argparse.ArgumentTypeError(
            f"--mesh wants 1-3 comma-separated sizes (data,model), got {spec!r}")
    return shape


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=list_archs())
    ap.add_argument("--variant", default="reduced", choices=["reduced", "full"])
    ap.add_argument("--policy", default="memory",
                    choices=["static", "memory", "sla", "combined"])
    ap.add_argument("--sla-ms", type=float, default=0.0)
    ap.add_argument("--b-max", type=int, default=16)
    ap.add_argument("--b-min", type=int, default=1,
                    help="Alg 1 lower batch bound B_min")
    ap.add_argument("--eps-d", type=float, default=2.0, metavar="MS",
                    help="SLA latency tolerance band eps_D (ms)")
    ap.add_argument("--eps-m", type=float, default=0.05,
                    help="memory-overflow probability budget eps_M")
    ap.add_argument("--alpha", type=int, default=16,
                    help="Alg 2 window-width control alpha")
    ap.add_argument("--delta", type=int, default=4,
                    help="Alg 2 anti-noise relaxation delta")
    ap.add_argument("--l0-refresh", type=int, default=32, metavar="N",
                    help="L0 offline refresh cadence in controller intervals")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV allocator block granularity (tokens)")
    ap.add_argument("--hbm-budget", type=int, default=0, metavar="BYTES",
                    help="M_max HBM budget override; 0 derives it from "
                         "the hardware profile")
    ap.add_argument("--batch-buckets", type=parse_buckets, default=None,
                    metavar="B1,B2,...",
                    help="decode batch shapes, e.g. '1,2,4,8'; "
                         "default: powers of two up to --b-max")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="trace replay (DESIGN §15): not yet ported")
    ap.add_argument("--ttft-sla", type=float, default=0.0, metavar="S",
                    help="per-request TTFT goodput SLA in seconds "
                         "(ttft_sla_s); 0 disables the check (DESIGN §15)")
    ap.add_argument("--tbt-sla", type=float, default=0.0, metavar="MS",
                    help="per-request mean-TBT goodput SLA in ms "
                         "(tbt_sla_ms); 0 disables the check (DESIGN §15)")
    ap.add_argument("--pool-tokens", type=int, default=4096)
    ap.add_argument("--max-context", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunked", action="store_true",
                    help="PD-fusion mode (chunked prefill)")
    ap.add_argument("--lanes", type=int, default=1,
                    help="concurrent prefill lanes")
    ap.add_argument("--pack", default="fifo", choices=["fifo", "srf"],
                    help="lane packer policy")
    ap.add_argument("--chunk-budget", type=int, default=512,
                    help="prefill token budget per fused interval")
    ap.add_argument("--paged", action="store_true",
                    help="physically paged KV cache (block-table pools)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="prefix sharing (DESIGN §10): not yet ported")
    ap.add_argument("--swap-space", type=int, default=0, metavar="BLOCKS",
                    help="host swap pool (DESIGN §11): not yet ported")
    ap.add_argument("--preempt", default="auto",
                    choices=["auto", "swap", "recompute"],
                    help="preemption flavor; without a swap pool every "
                         "preemption is a recompute")
    ap.add_argument("--profile", default="a100x8",
                    choices=sorted(PROFILES),
                    help="hardware profile of the swap-vs-recompute "
                         "crossover (DESIGN §11)")
    ap.add_argument("--overlap-depth", type=int, default=0,
                    help="async dispatch-ahead (DESIGN §14): only 0 is "
                         "ported")
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    metavar="DATA,MODEL",
                    help="mesh-sharded serving (DESIGN §12): not yet ported")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (cuda or cpu)")
    return ap


def serve_config(args) -> ServeConfig:
    buckets = args.batch_buckets or \
        tuple(2 ** i for i in range(0, args.b_max.bit_length()))
    return ServeConfig(policy=args.policy,
                       b_min=args.b_min, b_max=args.b_max,
                       d_sla_ms=args.sla_ms,
                       ttft_sla_s=args.ttft_sla,
                       tbt_sla_ms=args.tbt_sla,
                       eps_d_ms=args.eps_d, eps_m=args.eps_m,
                       alpha=args.alpha, delta=args.delta,
                       block_size=args.block_size,
                       hbm_budget_bytes=args.hbm_budget,
                       l0_refresh_interval=args.l0_refresh,
                       max_new_tokens=args.max_new,
                       batch_buckets=buckets,
                       kv_pool_tokens=args.pool_tokens,
                       chunked_prefill=args.chunked,
                       chunk_budget_tokens=args.chunk_budget,
                       n_prefill_lanes=args.lanes,
                       prefill_pack=args.pack,
                       paged_kv=args.paged,
                       prefix_cache=args.prefix_cache,
                       swap_space_blocks=args.swap_space,
                       preempt=args.preempt,
                       overlap_depth=args.overlap_depth,
                       mesh_shape=args.mesh or ())


def build_engine(args, cuda_graphs: Optional[bool] = None):
    """The model (random weights from --seed) and the engine the flags
    describe, its step graphs captured on the card (`Engine.warmup`).
    `cuda_graphs=False` runs the steps eagerly on the card."""
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine, check_ported

    if args.trace is not None:
        raise NotImplementedError("--trace is not yet ported to repro_torch")
    serve = serve_config(args)
    check_ported(serve)
    cfg = get_config(args.arch, args.variant)
    model = build_model(cfg, dtype=torch.float32 if args.variant == "reduced"
                        else torch.bfloat16, device=args.device)
    eng = Engine(model, model.init(args.seed), serve,
                 max_context=args.max_context, buckets=serve.batch_buckets,
                 prefill_chunk=16, seed=args.seed, device=args.device,
                 cuda_graphs=cuda_graphs)
    if eng.graphs.enabled:
        # every decode bucket and full-chunk lane shape before any request
        eng.warmup()
    return eng


def run(args, prompts: Optional[Sequence[List[int]]] = None,
        cuda_graphs: Optional[bool] = None):
    """`build_engine`, then submit `prompts` (default: --requests random
    prompts of 4-23 tokens from --seed, as the JAX CLI draws them) and
    serve them to completion. Returns the engine."""
    eng = build_engine(args, cuda_graphs)
    if prompts is None:
        rng = np.random.RandomState(args.seed)
        prompts = [list(map(int, rng.randint(0, eng.cfg.vocab_size,
                                             size=rng.randint(4, 24))))
                   for _ in range(args.requests)]
    for p in prompts:
        eng.submit(p)
    eng.run()
    return eng


def main(argv=None):
    eng = run(build_parser().parse_args(argv))
    print({k: round(v, 2) for k, v in eng.summary().items()})


if __name__ == "__main__":
    main()
