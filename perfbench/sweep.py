"""The knee sweep of an open-loop cell: one process, one engine, the cell's
traffic at rising rates; the knee is the highest rate whose queue does
not grow over the window.

    python3 perfbench/sweep.py --workload granite-chat --rates 1 2 3 4 \
        --seconds 30 --seed 11

For each rate, after the engine has drained the last one, a warm phase
and a window of the cell's mix at that rate; one JSON line a rate: the
requests due and answered, the tokens a second, the TTFT and TBT tails,
the mean decode batch, and the requests waiting for their first token
(due, not answered) over the window's first and last thirds. The queue
grows where the last third's mean exceeds one and a half times the
first's, and the first's by one request or more.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def grows(first: float, last: float) -> bool:
    """Whether the queue grew over the window: relative, so that a queue
    that doubles counts at any depth, with one request of slack for the
    noise of an almost empty queue."""
    return last > max(1.5 * first, first + 1.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from perfbench import drive, record, traffic
    from perfbench.cell import build_kernels
    from perfbench.registry import Bench
    from perfbench.stats import mean, percentile

    bench = Bench()
    cell = bench.cell(args.workload)
    config = bench.config(cell["config"])
    fam, port = bench.family(config)
    mix = bench.traffic(cell["traffic"])
    cfg = port.port_config(config["name"], config)
    dtype = getattr(torch, config.get("torch_dtype", "bfloat16"))
    if args.device == "cuda":
        build_kernels()
    weights = fam.make_weights(config, args.seed, args.device, dtype)
    eng = drive.build_engine(cfg, drive.engine_args(cell, args.seed,
                                                    args.device),
                             weights, dtype)
    warm = float(cell["warm_seconds"])
    docs_done = False
    for rate in args.rates:
        plan = traffic.plan(mix, rate, args.seed, args.seconds, warm,
                            int(config["vocab_size"]))
        if not docs_done:
            drive.prefill_setup(eng, plan)
            docs_done = True
        waiting = []

        def sample(d, t):
            if 0.0 <= t <= args.seconds:
                waiting.append((t, sum(1 for r in d.reqs
                                       if not r.token_times
                                       and not r.rejected)))

        d = drive.Driver(eng, plan, args.seconds, warm, on_step=sample)
        marks = d.run()
        while eng.step():           # drain before the next rate
            pass
        a, b = marks["start"], marks["end"]
        run = record.Run(cell=cell, config=config, seconds=args.seconds,
                         setup_s=0.0, reqs=d.reqs,
                         steps=[s for s in d.steps
                                if 0.0 <= s.t <= args.seconds],
                         start=a, end=b,
                         batch_trace=list(eng.batch_trace[int(a["batch_i"]):
                                                          int(b["batch_i"])]),
                         step_host=[], pool_tokens=int(eng.mem.eta),
                         family=fam)
        thirds = args.seconds / 3
        q1 = mean([n for t, n in waiting if t < thirds]) or 0.0
        q3 = mean([n for t, n in waiting if t >= 2 * thirds]) or 0.0
        win = run.window_reqs
        waits = [(r.token_times[0] if r.token_times else args.seconds)
                 - r.due for r in win]
        out = {"rate": rate, "due": len(win),
               "answered": sum(1 for r in win if r.token_times),
               "finished": sum(1 for r in win if r.finished),
               "rejected": sum(1 for r in win if r.rejected),
               "tokens_per_s": sum(1 for r in run.reqs for t in r.token_times
                                   if 0 <= t <= args.seconds) / args.seconds,
               "ttft_p50_s": percentile(waits, 50),
               "ttft_p90_s": percentile(waits, 90),
               "tbt_p50_ms": percentile(run.gaps_ms(), 50),
               "tbt_p95_ms": percentile(run.gaps_ms(), 95),
               "decode_batch_mean": mean(run.batch_trace),
               "waiting_first_third": q1, "waiting_last_third": q3,
               "queue_grows": grows(q1, q3)}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
