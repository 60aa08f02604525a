"""The port's engine against the port's simulator (DESIGN §7, §11, §14,
§15): the differential harness of tests/test_differential.py on the port,
at overlap depth 0, 1 and 2, and with the host swap tier on in the cases
where the JAX file has it. The same workload (all arrivals at 0) runs
through the engine (reduced granite-3-8b, fp32, CPU, paged) and through
its discrete-event twin; the controller-visible counters, the swap
counters, the finished and rejected sets and the goodput verdicts must
agree exactly.
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.core.telemetry import Telemetry
from repro_torch.models.model import build_model
from repro_torch.serving.cost_model import CostModel, PROFILES
from repro_torch.serving.engine import Engine
from repro_torch.serving.request import Request
from repro_torch.serving.sim import LengthDist, ServingSimulator
from repro_torch.serving.workload import reference_trace

MAX_CONTEXT = 96
_MODEL = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced engines run many tiny ops: one intra-op thread serves
    them faster than a pool, and keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup_model():
    if not _MODEL:
        cfg = get_config("granite-3-8b", "reduced")
        m = build_model(cfg, dtype=torch.float32, device="cpu")
        _MODEL.update(cfg=cfg, m=m, params=m.init(0))
    return _MODEL["cfg"], _MODEL["m"], _MODEL["params"]


def _engine(serve):
    cfg, m, params = setup_model()
    return Engine(m, params, serve, max_context=MAX_CONTEXT,
                  buckets=(1, 2, 4, 8), prefill_chunk=8, device="cpu")


def _sim(serve, mean_in, mean_out):
    cfg = setup_model()[0]
    sim = ServingSimulator(cfg, serve, CostModel(cfg, PROFILES["a100x8"]),
                           LengthDist(mean_in=mean_in, mean_out=mean_out),
                           seed=0, prefill_chunk=8, max_context=MAX_CONTEXT)
    # the engine's telemetry starts prior-free: match it exactly
    sim.tel = Telemetry()
    return sim


def run_pair(prompt_lens, max_new, serve, seed=0):
    """The identical workload through the engine and the sim twin."""
    cfg = setup_model()[0]
    eng = _engine(serve)
    rng = np.random.RandomState(seed)
    hs = [eng.submit(list(map(int, rng.randint(0, cfg.vocab_size,
                                               size=pl))),
                     max_new_tokens=max_new, arrival_time=0.0)
          for pl in prompt_lens]
    eng.run(max_steps=20_000)
    sim = _sim(serve, float(np.mean(prompt_lens)), float(max_new))
    for i, pl in enumerate(prompt_lens):
        # engine.submit caps max_new at the context budget; mirror it
        sim.waiting.append(Request(
            rid=i, arrival_time=0.0, prompt_len=pl,
            max_new_tokens=min(max_new, MAX_CONTEXT - pl - 1)))
    sim._all.extend(sim.waiting)
    return eng, hs, sim, sim.run(max_steps=20_000)


def run_trace_pair(events, serve):
    """A multi-turn trace through both twins, arrivals collapsed to 0 and
    max_new = min(l_out, config, context cap) on both sides."""
    eng = _engine(serve)
    hs = [eng.submit(list(e.tokens),
                     max_new_tokens=min(e.l_out, serve.max_new_tokens),
                     arrival_time=0.0) for e in events]
    eng.run(max_steps=20_000)
    sim = _sim(serve, sum(e.prompt_len for e in events) / len(events),
               sum(e.l_out for e in events) / len(events))
    for i, e in enumerate(events):
        sim.waiting.append(Request(
            rid=i, arrival_time=0.0, prompt_tokens=list(e.tokens),
            max_new_tokens=min(e.l_out, serve.max_new_tokens,
                               MAX_CONTEXT - e.prompt_len - 1)))
    sim._all.extend(sim.waiting)
    return eng, hs, sim, sim.run(max_steps=20_000)


def assert_parity(eng, hs, sim, res, ctx=""):
    s = eng.summary()
    assert eng.admitted_total == res.admitted, ctx
    assert eng.preemptions == res.preemptions, ctx
    assert eng.oom_events == res.oom_events, ctx
    assert eng.rejected == res.rejected, ctx
    for k in ("swap_outs", "swap_ins", "swap_out_bytes", "swap_in_bytes"):
        assert s[k] == getattr(res, k), (ctx, k)
    eng_done = {h.rid for h in hs
                if h.state.value == "finished" and not h.rejected}
    sim_done = {r.rid for r in sim._all
                if r.state.value == "finished" and not r.rejected}
    assert eng_done == sim_done, ctx
    assert {h.rid for h in hs if h.rejected} \
        == {r.rid for r in sim._all if r.rejected}, ctx
    assert eng.sla_requests_met == res.sla_requests_met, ctx
    assert eng.goodput_tokens == res.goodput_tokens, ctx
    assert {h.rid for h in hs if h.sla_met} \
        == {r.rid for r in sim._all if r.sla_met}, ctx
    assert not eng.waiting and not eng.active and not eng.prefilling \
        and not eng._inflight, ctx
    assert not sim.waiting and not sim.running and not sim.pending_prefill \
        and not sim.swapped, ctx
    # every placeholder was patched at retirement
    assert all(t is not None for h in hs for t in h.output_tokens), ctx


def serve_cfg(*, policy="static", b_max=4, pool_tokens=256, chunked=True,
              lanes=2, budget=24, overlap=0, ttft_sla=0.0, swap_blocks=0,
              preempt="auto"):
    return ServeConfig(policy=policy, b_max=b_max, max_new_tokens=6,
                       kv_pool_tokens=pool_tokens, block_size=16,
                       chunked_prefill=chunked, chunk_budget_tokens=budget,
                       n_prefill_lanes=lanes, paged_kv=True,
                       overlap_depth=overlap, ttft_sla_s=ttft_sla,
                       swap_space_blocks=swap_blocks, preempt=preempt)


@pytest.mark.parametrize("overlap", [0, 1, 2])
@pytest.mark.parametrize("chunked", [False, True])
def test_differential_tight_pool_preemption(chunked, overlap):
    """A pool too small for the batch forces recompute preemptions."""
    serve = serve_cfg(pool_tokens=160, chunked=chunked, b_max=4,
                      overlap=overlap)
    eng, hs, sim, res = run_pair([40, 44, 38, 46], max_new=12, serve=serve,
                                 seed=1)
    assert eng.preemptions > 0
    assert_parity(eng, hs, sim, res, ctx=f"overlap={overlap}")


@pytest.mark.parametrize("overlap", [0, 1, 2])
def test_differential_rejection_and_watermark(overlap):
    """Unservable prompts are rejected, watermark deferrals counted."""
    serve = serve_cfg(pool_tokens=128, b_max=4, chunked=True,
                      overlap=overlap)
    eng, hs, sim, res = run_pair([90, 20, 88, 24], max_new=4, serve=serve,
                                 seed=2)
    assert_parity(eng, hs, sim, res, ctx=f"overlap={overlap}")


@pytest.mark.parametrize("overlap", [0, 1, 2])
def test_differential_memory_policy(overlap):
    """Alg 1 decisions feed back on telemetry both twins produce alike,
    lagged by the same number of dispatched intervals."""
    serve = serve_cfg(policy="memory", pool_tokens=256, b_max=8,
                      overlap=overlap)
    eng, hs, sim, res = run_pair([24, 18, 30, 12, 26, 20], max_new=5,
                                 serve=serve, seed=3)
    assert_parity(eng, hs, sim, res, ctx=f"overlap={overlap}")


@pytest.mark.parametrize("overlap", [0, 1, 2])
def test_differential_async_overlap(overlap):
    """Under pool pressure Alg 1 defers at the watermark; the twins agree
    at every depth, and both record the host/device split."""
    serve = serve_cfg(policy="memory", pool_tokens=160, b_max=4,
                      overlap=overlap)
    eng, hs, sim, res = run_pair([40, 44, 38, 46, 26], max_new=12,
                                 serve=serve, seed=4)
    assert eng.oom_events > 0
    assert_parity(eng, hs, sim, res, ctx=f"overlap={overlap}")
    assert eng.summary()["step_host_s_mean"] > 0.0
    assert res.step_host_s_mean > 0.0 and res.step_device_s_mean > 0.0


@pytest.mark.parametrize("sla", [0.0, 1e-9])
@pytest.mark.parametrize("overlap", [0, 1, 2])
def test_differential_traced_load(overlap, sla):
    """A replayed multi-turn trace (DESIGN §15) through both twins, SLA
    disabled (met == finished) or unmeetable (met == 0), so wall-clock and
    sim-clock verdicts coincide."""
    events = reference_trace(14, seed=5, vocab_size=512, base_rate=4.0,
                             burst_rate=16.0, period_s=20.0, duty=0.25,
                             n_system_prompts=2, system_len=12,
                             user_mean=8.0, out_mean=5.0, length_cv=0.5,
                             p_followup=0.7, max_turns=3, turn_gap_s=2.0)
    assert any(e.parent_id is not None for e in events)
    serve = serve_cfg(policy="memory", pool_tokens=160, b_max=4,
                      overlap=overlap, ttft_sla=sla)
    eng, hs, sim, res = run_trace_pair(events, serve)
    assert all(h.state.value == "finished" or h.rejected for h in hs)
    if sla > 0.0:
        assert eng.sla_requests_met == 0 and res.sla_requests_met == 0
    else:
        assert eng.sla_requests_met == eng.total_finished
    assert_parity(eng, hs, sim, res, ctx=f"overlap={overlap} sla={sla}")


@given(st.integers(0, 10_000),
       st.integers(2, 5),
       st.sampled_from([10, 12, 16]),          # pool blocks
       st.booleans(),                          # chunked prefill
       st.sampled_from(["static", "memory"]),
       st.sampled_from([0, 1, 2]))             # overlap depth
@settings(max_examples=8, deadline=None)
def test_differential_randomized(seed, n_req, pool_blocks, chunked, policy,
                                 overlap):
    rng = np.random.RandomState(seed)
    prompt_lens = [int(rng.randint(6, 44)) for _ in range(n_req)]
    serve = serve_cfg(policy=policy, b_max=4, pool_tokens=pool_blocks * 16,
                      chunked=chunked, lanes=int(rng.randint(1, 3)),
                      overlap=overlap)
    eng, hs, sim, res = run_pair(prompt_lens, max_new=int(rng.randint(2, 7)),
                                 serve=serve, seed=seed)
    assert_parity(eng, hs, sim, res,
                  ctx=f"seed={seed} pool={pool_blocks} chunked={chunked} "
                      f"policy={policy} overlap={overlap}")


# ---------------------------------------------------------------------------
# the swap cases of tests/test_differential.py (DESIGN §11)


@pytest.mark.parametrize("overlap", [0, 2])
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("swap_blocks,preempt", [(0, "auto"), (16, "swap")])
def test_differential_tight_pool_swap(swap_blocks, preempt, chunked,
                                      overlap):
    """The tight pool with the swap axis: swap pool 0 under `auto`
    (recompute only) and 16 blocks under forced swap."""
    serve = serve_cfg(pool_tokens=160, swap_blocks=swap_blocks,
                      chunked=chunked, preempt=preempt, b_max=4,
                      overlap=overlap)
    eng, hs, sim, res = run_pair([40, 44, 38, 46], max_new=12, serve=serve,
                                 seed=1)
    assert eng.preemptions > 0
    if swap_blocks:
        assert eng.swap_outs > 0 and eng.swap_ins > 0
    assert_parity(eng, hs, sim, res,
                  ctx=f"swap={swap_blocks} overlap={overlap}")


@pytest.mark.parametrize("overlap", [0, 2])
def test_differential_memory_policy_swap(overlap):
    """Alg 1 with a 12-block swap pool under forced swap."""
    serve = serve_cfg(policy="memory", pool_tokens=256, b_max=8,
                      swap_blocks=12, preempt="swap", overlap=overlap)
    eng, hs, sim, res = run_pair([24, 18, 30, 12, 26, 20], max_new=5,
                                 serve=serve, seed=3)
    assert_parity(eng, hs, sim, res, ctx=f"overlap={overlap}")


@pytest.mark.parametrize("overlap", [0, 1, 2])
def test_differential_async_overlap_swap(overlap):
    """Pool pressure under Alg 1 with forced swap, at every depth."""
    serve = serve_cfg(policy="memory", pool_tokens=160, b_max=4,
                      swap_blocks=12, preempt="swap", overlap=overlap)
    eng, hs, sim, res = run_pair([40, 44, 38, 46, 26], max_new=12,
                                 serve=serve, seed=4)
    assert eng.oom_events > 0
    assert_parity(eng, hs, sim, res, ctx=f"overlap={overlap}")


@pytest.mark.parametrize("overlap,sla", [(0, 1e-9), (2, 0.0)])
def test_differential_traced_load_swap(overlap, sla):
    """The replayed multi-turn trace with a 16-block swap pool: unmeetable
    TTFT SLO at depth 0, SLA off at depth 2."""
    events = reference_trace(14, seed=5, vocab_size=512, base_rate=4.0,
                             burst_rate=16.0, period_s=20.0, duty=0.25,
                             n_system_prompts=2, system_len=12,
                             user_mean=8.0, out_mean=5.0, length_cv=0.5,
                             p_followup=0.7, max_turns=3, turn_gap_s=2.0)
    serve = serve_cfg(policy="memory", pool_tokens=160, b_max=4,
                      swap_blocks=16, preempt="swap", overlap=overlap,
                      ttft_sla=sla)
    eng, hs, sim, res = run_trace_pair(events, serve)
    assert all(h.state.value == "finished" or h.rejected for h in hs)
    if sla > 0.0:
        assert eng.sla_requests_met == 0 and res.sla_requests_met == 0
    else:
        assert eng.sla_requests_met == eng.total_finished
    assert_parity(eng, hs, sim, res, ctx=f"overlap={overlap} sla={sla}")


@given(st.integers(0, 10_000),
       st.integers(2, 5),
       st.sampled_from([10, 12, 16]),          # pool blocks
       st.sampled_from([0, 8, 24]),            # swap space blocks
       st.booleans(),                          # chunked prefill
       st.sampled_from(["static", "memory"]),
       st.sampled_from(["auto", "swap"]),
       st.sampled_from([0, 1, 2]))             # overlap depth
@settings(max_examples=8, deadline=None)
def test_differential_randomized_swap(seed, n_req, pool_blocks, swap_blocks,
                                      chunked, policy, preempt, overlap):
    rng = np.random.RandomState(seed)
    prompt_lens = [int(rng.randint(6, 44)) for _ in range(n_req)]
    serve = serve_cfg(policy=policy, b_max=4, pool_tokens=pool_blocks * 16,
                      swap_blocks=swap_blocks, chunked=chunked,
                      lanes=int(rng.randint(1, 3)), preempt=preempt,
                      overlap=overlap)
    eng, hs, sim, res = run_pair(prompt_lens, max_new=int(rng.randint(2, 7)),
                                 serve=serve, seed=seed)
    assert_parity(eng, hs, sim, res,
                  ctx=f"seed={seed} pool={pool_blocks} swap={swap_blocks} "
                      f"chunked={chunked} policy={policy} preempt={preempt} "
                      f"overlap={overlap}")
