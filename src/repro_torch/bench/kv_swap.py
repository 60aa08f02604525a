"""The two-tier K/V swap on the port (DESIGN §11): granite-3-8b served on
the paged pool under a pool too small for its batch, preemption relieved
by recompute or by the host swap tier, beside the port's simulator on the
same stream. The port's counterpart of `benchmarks/kv_swap.py`.

    python src/repro_torch/bench/kv_swap.py [--variant reduced|full]
        [--device cuda|cpu] [--src DIR] [--mode recompute swap]

The flags are `chip_smoke.py`'s serve flags with `--policy static
--pool-tokens 1536 --paged`; the swap mode adds `--swap-space 256
--preempt auto` (the cost model's crossover picks swap or recompute per
victim). The prompts are `chip_smoke.py`'s 12 (32-480 tokens, seed 0) in
the variant's vocabulary, all arriving at once. With `--src`,
`repro_torch` is imported from that source tree, so an older commit can be
run in the same call. Prints the card's name and power limit (on the
card), then one JSON line a mode: the reference bench's metrics
(`admitted_peak_tokens`: device plus host tokens held at once, the swap
counters and latency), the interval's host and device means, and the
simulator's counters on the same stream.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[3]

#: added to chip_smoke.SERVE_ARGS for both modes
TIER_ARGS = ["--policy", "static", "--pool-tokens", "1536", "--paged"]
MODES = {"recompute": [],
         "swap": ["--swap-space", "256", "--preempt", "auto"]}
#: seconds between the simulator's waves (the engine serves each wave to
#: completion before the next)
WAVE_S = 60.0


def prompts(vocab: int, n: int = 12, lo: int = 32, hi: int = 480,
            seed: int = 0) -> List[List[int]]:
    """n random prompts of lo..hi tokens in `vocab` from `seed`
    (`chip_smoke.py`'s serve prompts)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, size=rng.randint(
        lo, hi + 1)))) for _ in range(n)]


def request_sets(reqs) -> dict:
    """The finished, rejected and SLA-met request ids of a run."""
    return dict(
        finished=sorted(r.rid for r in reqs
                        if r.state.value == "finished" and not r.rejected),
        rejected=sorted(r.rid for r in reqs if r.rejected),
        sla_met=sorted(r.rid for r in reqs if r.sla_met))


#: the simulator's counters held against the engine's
SIM_KEYS = ("admitted", "preemptions", "oom_events", "rejected",
            "sla_requests_met", "goodput_tokens", "swap_outs", "swap_ins",
            "swap_out_bytes", "swap_in_bytes", "prefix_hit_tokens",
            "prefix_query_tokens", "prefix_hit_rate", "decode_steps",
            "ttft_mean_s", "ttft_p90_s")


def sim_twin(args, waves: Sequence[Sequence[List[int]]], max_new: int,
             prefill_chunk: int, max_context: int, cfg=None) -> dict:
    """The port's simulator on the engine's ServeConfig and token stream:
    wave k arrives at k x WAVE_S, every request runs to max_new tokens
    (capped at the context, as `Engine.submit` caps it), prior-free
    telemetry. `cfg`: the engine's config where it is not the flags'
    (a depth cut). Returns SIM_KEYS and the request sets (`sets`)."""
    from repro_torch.config.registry import get_config
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.launch import serve
    from repro_torch.serving.cost_model import PROFILES, CostModel
    from repro_torch.serving.request import Request
    from repro_torch.serving.sim import LengthDist, ServingSimulator

    cfg = cfg or get_config(args.arch, args.variant)
    lens = [len(p) for w in waves for p in w]
    sim = ServingSimulator(
        cfg, serve.serve_config(args), CostModel(cfg,
                                                 PROFILES[args.profile]),
        LengthDist(mean_in=sum(lens) / len(lens), mean_out=float(max_new)),
        prefill_chunk=prefill_chunk, max_context=max_context)
    sim.tel = Telemetry()
    for k, wave in enumerate(waves):
        for p in wave:
            mx = min(max_new, max_context - len(p) - 1)
            sim.waiting.append(Request(
                rid=len(sim._all), arrival_time=k * WAVE_S,
                prompt_tokens=list(p), true_output_len=mx,
                max_new_tokens=mx))
            sim._all.append(sim.waiting[-1])
    t0 = time.perf_counter()
    res = sim.run()
    return dict({k: getattr(res, k) for k in SIM_KEYS},
                sim_s=time.perf_counter() - t0, sets=request_sets(sim._all))


def serve_waves(argv: List[str], waves: Sequence[Sequence[List[int]]],
                on_built: Optional[Callable] = None) -> dict:
    """Serve `waves` (lists of prompts; each wave is submitted at once and
    served to completion before the next) through
    `launch.serve.build_engine` on the flags `argv`, then the simulator
    twin on the same stream. `on_built(engine)` runs after the build and
    warmup, before the first request. Returns the metrics, the output
    tokens, the twin's result, the requests and the engine."""
    import torch

    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    eng = serve.build_engine(args)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm = eng.graphs.stats()
    if on_built is not None:
        on_built(eng)
    hs, peak_tokens, peak_reqs = [], 0, 0
    t0 = time.perf_counter()
    for wave in waves:
        hs += [eng.submit(p) for p in wave]
        while eng.step():
            # K/V tokens held for admitted requests in both tiers
            peak_tokens = max(peak_tokens, eng.blocks.physical_used_tokens
                              + eng.blocks.swapped_tokens)
            peak_reqs = max(peak_reqs, len(eng.active)
                            + len(eng.prefilling) + len(eng.swapped))
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.summary()
    graphs = eng.graphs.stats()
    metrics = dict(
        admitted_peak_tokens=peak_tokens, admitted_peak_requests=peak_reqs,
        hbm_pool_tokens=int(s["pool_tokens"]), build_s=build_s,
        serve_s=wall, intervals=len(eng.step_host_trace),
        interval_s_mean=s["step_host_s_mean"] + s["step_device_s_mean"],
        host_blocks_free=eng.blocks.host_free_blocks,
        # first-use captures of tail-chunk shapes synchronise the device
        # and land in host time
        first_use_captures=graphs["captures"] - warm["captures"],
        first_use_capture_s=graphs["capture_s"] - warm["capture_s"],
        allocator_full=eng.blocks.free_blocks == eng.blocks.num_blocks,
        **{k: s[k] for k in (
            "finished", "admitted", "preemptions", "oom_events", "rejected",
            "decode_steps", "mean_batch", "prefill_tokens", "swap_outs",
            "swap_ins", "swap_out_bytes", "swap_in_bytes", "swapped_peak",
            "swap_latency_s_mean", "copy_bytes", "prefix_hit_rate",
            "prefix_hit_tokens", "prefix_query_tokens", "cached_blocks",
            "cache_evictions", "step_host_s_mean", "step_device_s_mean",
            "tbt_ms_mean", "ttft_mean_s", "ttft_p90_s", "throughput_tok_s",
            "sla_requests_met", "goodput_tokens")})
    twin = sim_twin(args, waves, args.max_new, eng.prefill_chunk,
                    eng.max_context)
    return dict(metrics=metrics, tokens=[h.output_tokens for h in hs],
                sim=twin, requests=hs, engine=eng)


def swap_argv(mode: str, base: List[str]) -> List[str]:
    """The flags of one mode on top of `base` (chip_smoke.SERVE_ARGS)."""
    return base + TIER_ARGS + MODES[mode]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None, modes=MODES, make_waves=None, make_argv=swap_argv,
         name="kv_swap") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="source tree to import repro_torch from")
    ap.add_argument("--variant", default="full",
                    choices=["reduced", "full"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", nargs="+", default=list(modes),
                    choices=list(modes))
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print(f"{name}: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.config.registry import get_config

    if args.device == "cuda":
        from repro_torch.kernels import _build

        print(card_line())
        torch.backends.cuda.matmul.allow_tf32 = False
        _build.build_all()
    vocab = get_config("granite-3-8b", args.variant).vocab_size
    waves = make_waves(vocab) if make_waves else [prompts(vocab)]
    for mode in args.mode:
        out = serve_waves(make_argv(mode, chip_smoke.SERVE_ARGS)
                          + ["--variant", args.variant,
                             "--device", args.device], waves)
        print(json.dumps({"bench": name, "mode": mode,
                          "variant": args.variant, **out["metrics"],
                          "sim": out["sim"]}), flush=True)
        del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
