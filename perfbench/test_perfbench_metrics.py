"""The end-to-end and per-layer arithmetic on synthetic timestamps."""
import pytest

from perfbench import record
from perfbench.registry import HERE, load_module
from perfbench.stats import mean, percentile


def metric(name):
    return load_module(HERE / "metrics" / f"{name}.py", "m_" + name).read


def run_of(reqs, seconds=10.0, **kw):
    base = dict(cell={"serve": ["--sla-ms", "50"]}, config={},
                seconds=seconds, setup_s=12.5, reqs=reqs, steps=[],
                start={"captures": 5, "prefix_hit_tokens": 0,
                       "prefix_query_tokens": 0},
                end={"captures": 5, "prefix_hit_tokens": 0,
                     "prefix_query_tokens": 0},
                batch_trace=[], step_host=[], pool_tokens=1000)
    base.update(kw)
    return record.Run(**base)


def steady(n=100, gap=0.02, seconds=10.0, stall_at=None, stall=0.0):
    """n requests due every 0.1 s, each with 20 tokens `gap` apart from a
    first token 0.05 s after it was due; a stall delays every token after
    `stall_at` by `stall`."""
    reqs = []
    for i in range(n):
        due = i * 0.1
        times = [due + 0.05 + k * gap for k in range(20)]
        if stall_at is not None:
            times = [t + stall if t >= stall_at else t for t in times]
        times = [t for t in times if t <= seconds]
        reqs.append(record.Req(index=i, warm=False, due=due, submitted=due,
                               prompt_len=10, max_new=20, token_times=times))
    return reqs


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert percentile(xs, 50) == 50
    assert percentile(xs, 90) == 90
    assert percentile(xs, 95) == 95
    assert percentile(xs, 99) == 99
    assert percentile([3.0], 90) == 3.0
    assert percentile([], 50) is None
    assert mean([]) is None and mean([1, 2, 3]) == 2


def test_steady_run_reads_its_gaps_and_waits():
    run = run_of(steady())
    assert metric("tbt_p50_ms")(run) == pytest.approx(20.0)
    assert metric("tbt_p95_ms")(run) == pytest.approx(20.0)
    # every request answered 0.05 s after it was due, but those due late
    # in the window whose first token is past its end
    assert metric("ttft_p90_s")(run) == pytest.approx(0.05)
    n = sum(len(r.token_times) for r in run.reqs)
    assert metric("throughput_tok_s")(run) == pytest.approx(n / 10.0)
    assert metric("setup_s")(run) == 12.5
    assert metric("tbt_sla_share")(run) == pytest.approx(100.0)
    assert metric("captures_in_window")(run) == 0


def clocked(stall_every=0, stall=0.1, n=100, seconds=10.0):
    """Requests due every 0.1 s on a serving loop whose intervals take
    20 ms, and `stall` s every `stall_every`-th interval; each request's
    first token comes at the first interval end 50 ms after it was due,
    then one a interval for 20 tokens."""
    ends, t, k = [], 0.0, 0
    while t < seconds + 1:
        k += 1
        t += stall if stall_every and k % stall_every == 0 else 0.02
        ends.append(t)
    reqs = []
    for i in range(n):
        due = i * 0.1
        j = next(j for j, e in enumerate(ends) if e >= due + 0.05)
        times = [e for e in ends[j:j + 20] if e <= seconds]
        reqs.append(record.Req(index=i, warm=False, due=due, submitted=due,
                               prompt_len=10, max_new=20, token_times=times))
    return reqs


def test_a_planted_stall_raises_the_tails():
    calm = run_of(clocked())
    stalled = run_of(clocked(stall_every=10, stall=0.1))
    assert metric("tbt_p50_ms")(calm) == pytest.approx(20.0)
    assert metric("tbt_p95_ms")(calm) == pytest.approx(20.0)
    assert metric("tbt_p50_ms")(stalled) == pytest.approx(20.0)
    assert metric("tbt_p95_ms")(stalled) == pytest.approx(100.0)
    assert metric("tbt_sla_share")(stalled) < 95.0
    # a stall of seconds reaches the TTFT tail
    long = run_of(clocked(stall_every=150, stall=2.5))
    assert metric("ttft_p90_s")(long) > 1.0 > metric("ttft_p90_s")(calm)
    assert metric("throughput_tok_s")(long) < \
        metric("throughput_tok_s")(calm)


def test_unanswered_requests_enter_the_tail_with_their_wait_so_far():
    reqs = steady(n=50, seconds=10.0)
    # 20 requests due at 2 s that never get a token: each waited 8 s
    reqs += [record.Req(index=50 + i, warm=False, due=2.0, submitted=2.0,
                        prompt_len=10, max_new=5) for i in range(20)]
    run = run_of(reqs)
    assert metric("ttft_p90_s")(run) == pytest.approx(8.0)
    # a refused request too, whatever it was given
    reqs[-1].rejected = True
    assert metric("ttft_p90_s")(run_of(reqs)) == pytest.approx(8.0)


def test_warm_requests_count_for_tokens_not_for_latency():
    warm = record.Req(index=0, warm=True, due=-1.0, submitted=-1.0,
                      prompt_len=1, max_new=4,
                      token_times=[-0.5, 0.5, 0.52, 0.54])
    run = run_of([warm], seconds=1.0)
    assert metric("throughput_tok_s")(run) == pytest.approx(3.0)
    assert metric("ttft_p90_s")(run) is None
    assert run.gaps_ms() == pytest.approx([20.0, 20.0])


def test_arrival_lag_and_counters():
    reqs = [record.Req(index=i, warm=False, due=i * 0.1,
                       submitted=i * 0.1 + (0.03 if i == 7 else 0.001),
                       prompt_len=1, max_new=1) for i in range(100)]
    run = run_of(reqs, batch_trace=[4, 8, 12], step_host=[0.002, 0.004],
                 end={"captures": 7, "prefix_hit_tokens": 900,
                      "prefix_query_tokens": 1000},
                 steps=[record.Step(t=0.1, used_tokens=100),
                        record.Step(t=0.2, used_tokens=300)])
    assert metric("arrival_lag_ms_p99")(run) == pytest.approx(1.0)
    assert metric("decode_batch_mean")(run) == 8
    assert metric("interval_host_ms")(run) == pytest.approx(3.0)
    assert metric("captures_in_window")(run) == 2
    assert metric("prefix_hit_rate")(run) == pytest.approx(90.0)
    assert metric("kv_used_share")(run) == pytest.approx(20.0)


def test_readers_that_find_nothing_return_nothing():
    run = run_of([])
    for name in ("prefix_hit_rate", "attention_roofline",
                 "device_idle_share", "model_mfu", "model_hbm_share",
                 "kv_used_share", "tbt_p50_ms", "decode_batch_mean"):
        assert metric(name)(run) is None, name


def test_model_step_and_roofline_counts():
    from perfbench.families import dense
    c = {"num_hidden_layers": 2, "hidden_size": 64,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "head_dim": 16, "intermediate_size": 128, "vocab_size": 256,
         "tie_word_embeddings": False}
    st = record.Step(t=0.5, decode_rows=2, decode_keys=30, prefill_tokens=4,
                     prefill_keys=10, prefill_kv_reads=4, first_tokens=1,
                     forwards=2, traced=True)
    lp = 2 * 64 * 64 + 2 * 64 * 32 + 3 * 64 * 128
    assert dense.layer_params(c) == lp
    flops = 6 * 2 * 2 * lp + 3 * 2 * 64 * 256 + 40 * 4 * 64 * 2
    run = run_of([], seconds=1.0, steps=[st], config=c, family=dense)
    assert metric("model_mfu")(run) == pytest.approx(
        100 * flops / 989e12)
    wb = 2 * (2 * (lp + 128) + 64 * 256 + 64)
    kvb = 2 * 2 * 16 * 2 * 2
    assert metric("model_hbm_share")(run) == pytest.approx(
        100 * (2 * wb + 30 * kvb) / 3.35e12)
    run.trace = record.Trace(window_s=1.0, busy_s=0.25,
                             device_ops=[("void mma_attention_kernel<1>",
                                          2e-9),
                                         ("gemm", 1.0)], idle_gaps=[])
    least = max((34 * kvb + 6 * 2 * 64 * 2 * 2) / 3.35e12,
                40 * 4 * 64 * 2 / 989e12)
    assert metric("attention_roofline")(run) == pytest.approx(
        100 * least / 2e-9)
    assert metric("device_idle_share")(run) == pytest.approx(75.0)


def test_resident_share_counts_cached_blocks_and_used_share_does_not():
    steps = [record.Step(t=0.1 * k, used_tokens=100, resident_tokens=900)
             for k in range(4)]
    run = run_of([], steps=steps)
    assert metric("kv_used_share")(run) == pytest.approx(10.0)
    assert metric("kv_resident_share")(run) == pytest.approx(90.0)
    assert metric("kv_resident_share")(run_of([])) is None


@pytest.mark.parametrize("first,last,grew", [
    (1.48, 3.12, True),      # doubled: grows, though by under 2 requests
    (0.46, 0.94, False),     # within one request of an almost empty queue
    (0.93, 0.77, False),
    (10.0, 14.0, False),     # deep, under one and a half times
    (10.0, 16.0, True)])
def test_sweep_queue_growth_is_relative(first, last, grew):
    sweep = load_module(HERE / "sweep.py", "perfbench_sweep_t")
    assert sweep.grows(first, last) is grew
