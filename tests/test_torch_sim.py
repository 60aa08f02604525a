"""The port's discrete-event simulator against the JAX package's (DESIGN
§7): the same configuration, cost model, lengths and arrivals give the same
`SimResult`, field for field (scalars, `batch_trace` and `decisions`),
across the four policies, chunked prefill on and off, overlap depth 0 and
2, the swap tier off and on, and prefix sharing off and on; also the
stateful families, a mesh-sharded pool, timed arrivals and the sampled
length law of `add_requests`.
"""
import dataclasses

import pytest

from repro.config.base import ServeConfig as JServeConfig
from repro.config.registry import get_config as jax_config
from repro.serving import workload as jw
from repro.serving.cost_model import CostModel as JCostModel, \
    PROFILES as JPROFILES
from repro.serving.sim import LengthDist as JLengthDist, \
    ServingSimulator as JSim
from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.serving import workload as pw
from repro_torch.serving.cost_model import CostModel, PROFILES
from repro_torch.serving.sim import LengthDist, SimResult, ServingSimulator

LENGTHS = dict(mean_in=96.0, mean_out=48.0)


def _pair(arch, serve_kw, *, variant="full", profile="a100x8",
          lengths=LENGTHS, seed=0, **sim_kw):
    cfg, jcfg = get_config(arch, variant), jax_config(arch, variant)
    ours = ServingSimulator(cfg, ServeConfig(**serve_kw),
                            CostModel(cfg, PROFILES[profile]),
                            LengthDist(**lengths), seed=seed, **sim_kw)
    ref = JSim(jcfg, JServeConfig(**serve_kw),
               JCostModel(jcfg, JPROFILES[profile]),
               JLengthDist(**lengths), seed=seed, **sim_kw)
    return ours, ref


def _same(ours, ref):
    """Run both and compare every SimResult field (decisions included)."""
    a, b = ours.run(), ref.run()
    assert [f.name for f in dataclasses.fields(a)] \
        == [f.name for f in dataclasses.fields(b)]
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    for k in db:
        assert da[k] == db[k], k
    assert (a.throughput_tok_s, a.goodput_tok_s) \
        == (b.throughput_tok_s, b.goodput_tok_s)
    return a


@pytest.mark.parametrize("prefix", [False, True], ids=["noprefix", "prefix"])
@pytest.mark.parametrize("swap", [0, 16], ids=["noswap", "swap16"])
@pytest.mark.parametrize("overlap", [0, 2])
@pytest.mark.parametrize("chunked", [False, True], ids=["fused0", "fused1"])
@pytest.mark.parametrize("policy", ["static", "memory", "sla", "combined"])
def test_sim_result_matches_jax(policy, chunked, overlap, swap, prefix):
    serve_kw = dict(policy=policy, b_max=16, d_sla_ms=40.0,
                    ttft_sla_s=2.0, tbt_sla_ms=40.0, kv_pool_tokens=512,
                    block_size=16, chunked_prefill=chunked,
                    chunk_budget_tokens=256, n_prefill_lanes=2,
                    max_new_tokens=64, paged_kv=True,
                    batch_buckets=(1, 2, 4, 8, 16),
                    swap_space_blocks=swap, preempt="auto",
                    prefix_cache=prefix, overlap_depth=overlap)
    ours, ref = _pair("granite-3-8b", serve_kw, prefill_chunk=64,
                      max_context=1024)
    if prefix:
        for mod, sim in ((pw, ours), (jw, ref)):
            mod.feed_tokens(sim, mod.shared_prefix(
                4.0, 40, vocab_size=500, system_len=64, mean_out=40.0,
                seed=1))
    else:
        ours.add_requests(40, arrival_rate=6.0)
        ref.add_requests(40, arrival_rate=6.0)
    res = _same(ours, ref)
    assert res.finished + res.rejected == 40
    if prefix:
        assert res.prefix_hit_tokens > 0


def test_the_grid_reaches_preemption_swap_and_sharing():
    """The grid above is not vacuous: its pool preempts, swaps both ways,
    shares prefixes and evicts cached blocks."""
    serve_kw = dict(policy="static", b_max=16, kv_pool_tokens=512,
                    chunked_prefill=False, chunk_budget_tokens=256,
                    n_prefill_lanes=2, max_new_tokens=64, paged_kv=True,
                    swap_space_blocks=16, prefix_cache=True)
    ours, ref = _pair("granite-3-8b", serve_kw, prefill_chunk=64,
                      max_context=1024)
    for mod, sim in ((pw, ours), (jw, ref)):
        mod.feed_tokens(sim, mod.shared_prefix(4.0, 40, vocab_size=500,
                                               system_len=64, mean_out=40.0,
                                               seed=1))
    res = _same(ours, ref)
    # some victims swap, shared ones recompute
    assert res.preemptions > res.swap_outs > 0 and res.swap_ins > 0
    assert res.prefix_hit_tokens > 0 and res.cache_evictions > 0


@pytest.mark.parametrize("overlap", [0, 2])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_stateful_families_match_jax(arch, overlap):
    """mamba2 (no K/V: the pool caps requests by their state) and
    recurrentgemma (windowed K/V plus state)."""
    serve_kw = dict(policy="memory", b_max=32, chunked_prefill=True,
                    n_prefill_lanes=2, max_new_tokens=32,
                    overlap_depth=overlap)
    ours, ref = _pair(arch, serve_kw, prefill_chunk=32)
    ours.add_requests(30, arrival_rate=10.0)
    ref.add_requests(30, arrival_rate=10.0)
    assert _same(ours, ref).finished == 30


@pytest.mark.parametrize("mesh", [(1, 2), (2, 4)])
def test_sharded_pool_matches_jax(mesh):
    """kv_shard_factor scales the pool under a mesh (DESIGN §12)."""
    serve_kw = dict(policy="combined", b_max=32, d_sla_ms=60.0,
                    mesh_shape=mesh, max_new_tokens=32)
    ours, ref = _pair("granite-3-8b", serve_kw, profile="h800x8")
    ours.add_requests(24)
    ref.add_requests(24)
    res = _same(ours, ref)
    assert res.model_shards == float(mesh[1])


def test_fixed_lengths_and_repeated_feeds_match_jax():
    """The PanGu fixed-length law, add_requests called twice and a burst
    workload fed after it: rids offset, idle advance to late arrivals."""
    serve_kw = dict(policy="sla", b_max=24, d_sla_ms=30.0,
                    max_new_tokens=128)
    lengths = dict(mean_in=128.0, mean_out=128.0, fixed=True)
    ours, ref = _pair("granite-3-8b", serve_kw, lengths=lengths, seed=3)
    for mod, sim, ld in ((pw, ours, LengthDist), (jw, ref, JLengthDist)):
        sim.add_requests(6)
        sim.add_requests(6, arrival_rate=0.5)
        mod.feed(sim, mod.bursty(0.2, 4.0, 20.0, 0.3, 10,
                                 ld(**LENGTHS), seed=4))
    res = _same(ours, ref)
    last = max(r.arrival_time for r in ours._all)
    assert res.finished == 22 and res.duration_s > last > 0.0


def test_sim_result_keeps_the_reference_fields():
    from repro.serving.sim import SimResult as JSimResult

    assert [(f.name, f.type) for f in dataclasses.fields(SimResult)] \
        == [(f.name, f.type) for f in dataclasses.fields(JSimResult)]
