"""One run of one cell: set-up, the warm phase, the measured window, the
metrics, and the comparison with the plain reference."""
from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import torch

from perfbench import check, drive, profile, record, traffic
from perfbench.registry import Bench


def build_kernels() -> None:
    """Build the port's CUDA libraries that are missing or stale, all at
    once (the port builds them one by one at first use otherwise); they
    land in the checkout's `build/`, so a second run finds them."""
    from repro_torch.kernels import _build

    stale = getattr(_build, "_stale", None)
    if stale is not None and any(stale(n) for n in _build.SIGNATURES):
        _build.build_all()


def served(driver: drive.Driver, n: int):
    """(index, prompt, tokens) of the finished requests whose every token
    the caller has read: the window's, or the warm phase's too where the
    window finished fewer than n."""
    out = []
    for warm in (False, True):
        for rec in driver.reqs:
            r = driver.engine_reqs.get(rec.index)
            if r is not None and rec.warm == warm and not rec.rejected \
                    and rec.finished and None not in r.output_tokens:
                out.append((rec.index, list(r.prompt_tokens),
                            list(r.output_tokens)))
        if len(out) >= n:
            break
    return out


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_start: Optional[float] = None,
             control: bool = False) -> Dict:
    """Run cell `name` once; returns the result line as a dict (its last
    key, `check`, holds each number compared beside its limit).
    `control`: judge the control in the program's place (the tokens the
    float8 reference puts first on the same requests, through the same
    limit), and give the program's own widest gap beside it as
    `program_widest_gap` (`control.py`; the benchmark's runs never do)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = bench.cell(name)
    config = bench.config(cell["config"])
    fam, port = bench.family(config)
    mix = bench.traffic(cell["traffic"])
    cfg = port.port_config(config["name"], config)
    dtype = getattr(torch, config.get("torch_dtype", "bfloat16"))
    cuda = device == "cuda"
    if cuda:
        build_kernels()
        torch.cuda.reset_peak_memory_stats()
    weights = fam.make_weights(config, seed, device, dtype)
    args = drive.engine_args(cell, seed, device)
    eng = drive.build_engine(cfg, args, weights, dtype)
    warm = float(cell["warm_seconds"])
    plan = traffic.plan(mix, float(cell.get("rate_per_s", 0.0)), seed,
                        seconds, warm, int(config["vocab_size"]))
    drive.prefill_setup(eng, plan)
    tracer = None
    if trace:
        ts = min(float(cell["trace_seconds"]), seconds)
        tracer = drive.Tracer(seconds - ts, cuda)
    driver = drive.Driver(eng, plan, seconds, warm, tracer)
    marks = driver.run()
    setup_s = driver.t0_abs - t_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = profile.read(tracer.prof) if tracer is not None else None
    a, b = marks["start"], marks["end"]
    run = record.Run(
        cell=cell, config=config, seconds=seconds, setup_s=setup_s,
        reqs=driver.reqs,
        steps=[s for s in driver.steps if 0.0 <= s.t <= seconds],
        start=a, end=b,
        batch_trace=list(eng.batch_trace[int(a["batch_i"]):
                                         int(b["batch_i"])]),
        step_host=list(eng.step_host_trace[int(a["host_i"]):
                                           int(b["host_i"])]),
        pool_tokens=int(eng.mem.eta), trace=tr, family=fam)
    n_check = int(cell["check"]["sample_requests"])
    finished = served(driver, n_check)
    # the program's state is freed before the reference runs
    del driver, eng, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    picked = check.sample(finished, seed, n_check)
    served_g, control_g = check.gaps(fam, config, weights, picked,
                                     plan.documents, control=control)
    # with `control`, the float8 reference's tokens stand in the served
    # tokens' place and are what `correct` judges
    g = control_g if control else served_g
    widest = max(g) if g else None
    limit = float(cell["check"]["gap_limit"])
    metrics = bench.read_metrics(run, name, trace)
    window = run.window_reqs
    out = {"correct": widest is not None and widest <= limit,
           "attempted": len(window),
           "failed": sum(r.rejected for r in window),
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name()
                      if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if tr is not None:
        out["device"]["busy_s"] = tr.busy_s
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = profile.breakdown(tr)
    out["served_tokens_compared"] = len(g)
    if control:
        out["program_widest_gap"] = max(served_g) if served_g else None
    out["check"] = check.verdict(widest, limit)
    return out
