"""Serving CLI of the port: the continuous-batching engine on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --variant full \
        --policy memory --requests 12 --chunked --lanes 2

Every flag of the JAX package's `launch/serve.py`, with the same names and
defaults, plus `--device` (default cuda; `--device cpu` runs the plain
PyTorch path). `--overlap-depth K` keeps K intervals dispatched ahead of
retirement (DESIGN §14); `--trace PATH` replays a `repro-trace` file
(DESIGN §15). The memory tiers run on the paged pool (`--paged`) of the
attention-only families: `--prefix-cache` shares indexed prompt blocks
(DESIGN §10), `--swap-space N --preempt auto|swap|recompute` offloads
preemption victims to an N-block host pool, `--profile` pricing the
swap-vs-recompute crossover (DESIGN §11). `--mesh DATA,MODEL` serves
tensor-parallel (DESIGN §12, the dense attention family) in DATA x MODEL
rank processes (`launch.mesh.spawn_ranks`): NCCL on `--device cuda` (one
card a rank), gloo on `--device cpu`; every rank serves the same requests
and rank 0 prints the summary. The VLM and enc-dec archs serve with 16
cross keys a request, each request's extras drawn from --seed after its
prompt, as the JAX CLI draws them.
"""
from __future__ import annotations

import argparse
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, ServeConfig
from repro_torch.config.registry import get_config, list_archs
from repro_torch.launch.mesh import spawn_ranks
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
                    help="replay a repro-trace JSONL file (DESIGN §15): "
                         "its requests in file order, max_new_tokens = "
                         "min(l_out, --max-new); --requests is ignored")
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
                    help="prefix sharing (DESIGN §10): ref-counted shared "
                         "prompt blocks with copy-on-write (paged, "
                         "attention-only families)")
    ap.add_argument("--swap-space", type=int, default=0, metavar="BLOCKS",
                    help="host swap pool of BLOCKS blocks (DESIGN §11): "
                         "preemption may offload a victim's K/V instead "
                         "of recomputing it (paged, attention-only "
                         "families)")
    ap.add_argument("--preempt", default="auto",
                    choices=["auto", "swap", "recompute"],
                    help="preemption flavor; without a swap pool every "
                         "preemption is a recompute")
    ap.add_argument("--profile", default="a100x8",
                    choices=sorted(PROFILES),
                    help="hardware profile of the swap-vs-recompute "
                         "crossover (DESIGN §11)")
    ap.add_argument("--overlap-depth", type=int, default=0,
                    help="async dispatch-ahead (DESIGN §14): intervals "
                         "left in flight after each step; 0 = synchronous")
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    metavar="DATA,MODEL",
                    help="tensor-parallel serving (DESIGN §12) in DATA x "
                         "MODEL rank processes: NCCL on cuda, gloo on cpu")
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


#: cross keys a request of the CLI's VLM and enc-dec runs, as the JAX CLI
CLI_ENC_LEN = 16


def build_engine(args, cuda_graphs: Optional[bool] = None,
                 cfg: Optional[ModelConfig] = None,
                 dtype: Optional[torch.dtype] = None,
                 enc_len: Optional[int] = None):
    """The model (random weights from --seed) and the engine the flags
    describe, its step graphs captured on the card (`Engine.warmup`).
    `cuda_graphs=False` runs the steps eagerly on the card. `cfg` replaces
    the --arch / --variant configuration (a variant the registry does not
    name, e.g. `mistral_nemo_12b.sliding(window=256)`). `dtype` replaces
    the weights' and activations' type (fp32 for --variant reduced, else
    bf16). `enc_len`: cross keys a request of a VLM or enc-dec arch
    (default CLI_ENC_LEN; `model.default_enc_len` gives the stub
    frontends' real lengths). With --mesh the model is this rank's, on
    the ambient serving group (`launch.mesh.make_serving_group`)."""
    from repro_torch.distributed.sharding import serving_group
    from repro_torch.models.model import build_model, default_enc_len
    from repro_torch.serving.cost_model import CostModel
    from repro_torch.serving.engine import Engine, check_ported

    serve = serve_config(args)
    cfg = cfg or get_config(args.arch, args.variant)
    check_ported(serve, cfg)
    group = serving_group() if args.mesh else None
    if args.mesh and group is None:
        raise ValueError("--mesh serves in rank processes: call serve_mesh, "
                         "or make_serving_group in each rank first")
    dtype = dtype or (torch.float32 if args.variant == "reduced"
                      else torch.bfloat16)
    model = build_model(cfg, dtype=dtype, device=args.device, group=group)
    if not default_enc_len(cfg):
        enc_len = 0
    elif enc_len is None:
        enc_len = CLI_ENC_LEN
    eng = Engine(model, model.init(args.seed), serve,
                 max_context=args.max_context, buckets=serve.batch_buckets,
                 prefill_chunk=16, enc_len=enc_len, seed=args.seed,
                 device=args.device, cuda_graphs=cuda_graphs,
                 cost=CostModel(cfg, PROFILES[args.profile]))
    if eng.graphs.enabled:
        # every decode bucket and full-chunk lane shape before any request
        eng.warmup()
    return eng


def trace_requests(path: str, vocab_size: int, seed: int,
                   max_new: int) -> List[Tuple[List[int], int]]:
    """(prompt tokens, max_new_tokens) of each request of a repro-trace
    file, in file order, as the JAX CLI submits them: token records with
    ids folded into the vocabulary, length records with tokens drawn from
    `seed`, and max_new_tokens = max(1, min(l_out, max_new)). Service is
    as fast as possible; arrival gating lives in the simulator."""
    from repro_torch.serving.workload import load_trace_events, trace_prompts

    return [(toks, max(1, min(lo, max_new))) for toks, lo in trace_prompts(
        load_trace_events(path), vocab_size, seed=seed)]


def extras_drawer(eng, rng: np.random.RandomState):
    """A function drawing one request's extras from `rng` (standard
    normal, (1, enc_len, d), fp32), or None for a family without them:
    the JAX CLI's `mk_extras`."""
    from repro_torch.models.backbone import extras_key

    if not eng.enc_len:
        return lambda: None
    key = extras_key(eng.cfg)
    return lambda: {key: rng.randn(1, eng.enc_len, eng.cfg.d_model)
                    .astype(np.float32)}


def run(args, prompts: Optional[Sequence[List[int]]] = None,
        cuda_graphs: Optional[bool] = None):
    """`build_engine`, then submit `prompts` (default: the requests of
    --trace, or --requests random prompts of 4-23 tokens from --seed, as
    the JAX CLI draws them) and serve them to completion; a VLM or enc-dec
    request's extras come from the same --seed stream right after its
    prompt's draw (after every prompt's with `prompts` or --trace), as the
    JAX CLI's. Returns the engine; its requests, in submission order, are
    `eng.cli_requests`."""
    eng = build_engine(args, cuda_graphs)
    rng = np.random.RandomState(args.seed)
    mk_extras = extras_drawer(eng, rng)
    if prompts is not None:
        reqs = [(p, 0, mk_extras()) for p in prompts]
    elif args.trace is not None:
        reqs = [(p, n, mk_extras()) for p, n in trace_requests(
            args.trace, eng.cfg.vocab_size, args.seed, args.max_new)]
    else:
        reqs = []
        for _ in range(args.requests):
            p = list(map(int, rng.randint(0, eng.cfg.vocab_size,
                                          size=rng.randint(4, 24))))
            reqs.append((p, 0, mk_extras()))
    eng.cli_requests = [eng.submit(p, max_new_tokens=max_new, extras=extras)
                        for p, max_new, extras in reqs]
    eng.run()
    return eng


def _mesh_rank(rank: int, world: int, args,
               prompts: Optional[Sequence[List[int]]]) -> Dict[str, object]:
    """One rank of `serve_mesh`: join the group, serve, and check that
    every rank decoded the same tokens."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_serving_group

    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        backend = "gloo"
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    group = make_serving_group(args.mesh, backend, rank, world)
    eng = run(args, prompts)
    tokens = [r.output_tokens for r in eng.cli_requests]
    every = [None] * world
    dist.all_gather_object(every, tokens, group=group.control)
    return {"summary": eng.summary(), "tokens": tokens,
            "ranks_agree": all(t == tokens for t in every)}


def serve_mesh(args, prompts: Optional[Sequence[List[int]]] = None
               ) -> Dict[str, object]:
    """`run` under --mesh: one rank process per mesh position, each
    serving the same requests on its shard; returns rank 0's summary, its
    output tokens, and whether every rank's tokens agreed (raises if
    not)."""
    out = spawn_ranks(_mesh_rank, math.prod(args.mesh), (args, prompts))
    if not out["ranks_agree"]:
        raise AssertionError("the ranks decoded different tokens")
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    summary = serve_mesh(args)["summary"] if args.mesh \
        else run(args).summary()
    print({k: round(v, 2) for k, v in summary.items()})


if __name__ == "__main__":
    main()
