"""Prefix sharing in the port's engine (DESIGN §10), on the CPU (reduced
granite-3-8b, fp32), with the JAX engine's weights.

* The engine tests of tests/test_prefix_cache.py on the port: prefix on and
  off give bitwise-identical tokens with no copy, evicted cache blocks are
  reused without stale positions, a preempted request re-hits its own
  blocks, the engine's hit rate is the simulator's, the simulator charges
  only the suffix, and the contiguous layout ignores the flag.
* The port against the JAX engine with prefix sharing on, at depth 0 and
  2: the same block tables after every step(), tokens and counters.
* A forced copy-on-write: `_cow_blocks` leaves the destination's K, V and
  pos rows equal to the source's and counts the JAX engine's copy bytes.
"""
import numpy as np
import pytest
import torch

from test_torch_preemption import ENGINE_KW, lockstep, serve_kw, weights

from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.serving.cost_model import PROFILES, CostModel
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_cache import BlockManager
from repro_torch.serving.sim import LengthDist, ServingSimulator
from repro_torch.serving.workload import feed_tokens, shared_prefix


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced engines run many tiny ops: one intra-op thread serves
    them faster than a pool, and keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def engine(serve: ServeConfig, **kw) -> Engine:
    _, _, _, m, p = weights()
    return Engine(m, p, serve, device="cpu", **kw)


def rand_tokens(rng, n):
    return list(map(int, rng.randint(0, weights()[0].vocab_size, size=n)))


@pytest.mark.parametrize("chunked", [False, True])
def test_engine_prefix_on_off_bitwise_identical(chunked):
    """A shared-system-prompt burst after a warming wave: the same tokens
    with prefix sharing on and off, no copy bytes, and hits when on."""
    rng = np.random.RandomState(0)
    system = rand_tokens(rng, 40)
    prompts = [system + rand_tokens(rng, 6 + i) for i in range(4)]

    def run(prefix):
        serve = ServeConfig(policy="static", b_max=4, max_new_tokens=5,
                            kv_pool_tokens=2048, chunked_prefill=chunked,
                            chunk_budget_tokens=16, n_prefill_lanes=2,
                            paged_kv=True, prefix_cache=prefix)
        eng = engine(serve, max_context=128, buckets=(1, 2, 4),
                     prefill_chunk=8)
        hs = [eng.submit(prompts[0], max_new_tokens=5)]
        eng.run()
        hs += [eng.submit(p, max_new_tokens=5) for p in prompts]
        eng.run()
        assert eng.total_finished == 5
        return [h.output_tokens for h in hs], eng

    out_off, eng_off = run(False)
    out_on, eng = run(True)
    assert out_off == out_on
    assert eng.copy_rows == 0 and eng.copy_bytes == 0
    s = eng.summary()
    assert s["prefix_hit_tokens"] >= 2 * 16
    assert s["prefix_hit_rate"] > 0
    assert s["logical_used_tokens"] >= s["physical_used_tokens"]
    if chunked:
        # only the suffixes were prefilled (the packer's token feed)
        assert s["prefill_tokens"] == eng_off.summary()["prefill_tokens"] \
            - s["prefix_hit_tokens"] > 0


@pytest.mark.parametrize("chunked", [False, True])
def test_engine_eviction_reuse_keeps_outputs_identical(chunked):
    """Cache blocks evicted for reuse lose their stale positions before
    their new tenant's first attention read: many distinct prompts in a
    small pool, then a re-arrival, give prefix-off's tokens."""
    rng = np.random.RandomState(7)
    prompts = [rand_tokens(rng, 36) for _ in range(5)]

    def run(prefix):
        serve = ServeConfig(policy="static", b_max=2, max_new_tokens=4,
                            kv_pool_tokens=128, block_size=16,
                            chunked_prefill=chunked, chunk_budget_tokens=16,
                            paged_kv=True, prefix_cache=prefix)
        eng = engine(serve, max_context=64, buckets=(1, 2), prefill_chunk=8)
        outs = []
        for p in prompts + [prompts[0]]:
            h = eng.submit(p, max_new_tokens=4)
            eng.run(max_steps=2000)
            outs.append(h.output_tokens)
        return outs, eng

    out_off, _ = run(False)
    out_on, eng = run(True)
    assert out_off == out_on
    assert eng.blocks.cache_evictions > 0
    assert eng.copy_bytes == 0


def test_engine_preempted_request_rehits_its_own_blocks():
    """A recompute re-probes the index: the evicted request's own cached
    prompt blocks map back, all but the demoted tail block; and in the
    engine a recompute victim under prefix sharing re-admits with a hit."""
    bm = BlockManager(total_tokens=320, block_size=16, prefix_cache=True)
    p = list(range(48))
    bm.allocate(1, 0, 49)
    bm.commit_prefill(1, p, 48)
    bm.free(1)
    assert bm.acquire_prefix(1, p) == 32

    eng = engine(ServeConfig(**serve_kw(prefix=True)), **ENGINE_KW)
    rng = np.random.RandomState(1)
    hs = [eng.submit(rand_tokens(rng, n), max_new_tokens=12,
                     arrival_time=0.0) for n in (40, 44, 38, 46)]
    eng.run(max_steps=5000)
    assert eng.total_finished == 4 and eng.preemptions > 0
    assert eng.blocks.prefix_hit_tokens > 0
    assert all(len(h.output_tokens) == 12 for h in hs)


def test_engine_vs_sim_hit_rates_agree():
    """The same token stream in waves through the engine and the port's
    simulator: the same prefix query and hit tokens."""
    cfg = weights()[0]
    arrivals = shared_prefix(rate=4.0, n=10, vocab_size=cfg.vocab_size,
                             n_system_prompts=2, system_len=48,
                             user_len=(4, 10), mean_out=6.0,
                             p_followup=0.8, max_turns=3, turn_gap_s=100.0,
                             seed=3)
    waves = {}
    for t, tk, lo in arrivals:
        waves.setdefault(int(t // 50), []).append((t, tk, lo))
    serve = ServeConfig(policy="static", b_max=4, max_new_tokens=6,
                        kv_pool_tokens=4096, chunked_prefill=True,
                        chunk_budget_tokens=24, n_prefill_lanes=2,
                        paged_kv=True, prefix_cache=True)
    eng = engine(serve, max_context=256, buckets=(1, 2, 4), prefill_chunk=8)
    for k in sorted(waves):
        for _, tk, _ in waves[k]:
            eng.submit(list(tk), max_new_tokens=6)
        eng.run(max_steps=5000)
    pcfg = get_config("granite-3-8b", "reduced")
    sim = ServingSimulator(pcfg, serve, CostModel(pcfg, PROFILES["a100x8"]),
                           LengthDist(mean_in=60, mean_out=6), seed=0,
                           prefill_chunk=8, max_context=256)
    feed_tokens(sim, [(50.0 * (i + 1), tk, 6)
                      for i, k in enumerate(sorted(waves))
                      for _, tk, _ in waves[k]])
    res = sim.run()
    assert eng.blocks.prefix_query_tokens == sim.blocks.prefix_query_tokens
    assert eng.blocks.prefix_hit_tokens == sim.blocks.prefix_hit_tokens
    assert eng.summary()["prefix_hit_rate"] == res.prefix_hit_rate > 0


def test_sim_charges_only_suffix_to_prefill_budget():
    """A second arrival of a cached 128-token prompt prefills only its
    demoted tail block in the port's simulator."""
    cfg = get_config("granite-3-8b", "full")
    p = list(np.random.RandomState(5).randint(0, 1000, size=128))

    def run(prefix):
        serve = ServeConfig(policy="static", b_max=2, max_new_tokens=4,
                            kv_pool_tokens=4096, chunked_prefill=True,
                            chunk_budget_tokens=16, paged_kv=True,
                            prefix_cache=prefix)
        sim = ServingSimulator(cfg, serve, CostModel(cfg,
                                                     PROFILES["a100x8"]),
                               LengthDist(mean_in=128, mean_out=4), seed=0,
                               prefill_chunk=16)
        feed_tokens(sim, [(0.0, p, 4), (1000.0, p, 4)])
        assert sim.run().finished == 2
        return sim

    sim_off, sim_on = run(False), run(True)
    assert sim_on.blocks.prefix_hit_tokens == 112
    assert sim_on.tel.prefill_tokens_total \
        < sim_off.tel.prefill_tokens_total - 64


def test_paged_off_path_unchanged_by_prefix_flag():
    """Without the paged pool the flag is inert: the contiguous engine's
    tokens, and no prefix state."""
    rng = np.random.RandomState(1)
    prompts = [rand_tokens(rng, 20) for _ in range(3)]

    def run(prefix):
        serve = ServeConfig(policy="memory", b_max=2, max_new_tokens=4,
                            kv_pool_tokens=1024, chunked_prefill=True,
                            chunk_budget_tokens=16, paged_kv=False,
                            prefix_cache=prefix)
        eng = engine(serve, max_context=64, buckets=(1, 2), prefill_chunk=8)
        hs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run()
        return [h.output_tokens for h in hs], eng

    out_a, _ = run(False)
    out_b, eng_b = run(True)
    assert out_a == out_b
    assert not eng_b.prefix
    assert eng_b.blocks.prefix_hit_tokens == 0


# ---------------------------------------------------------------------------
# the port against the JAX engine


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("chunked", [False, True], ids=["fused0", "fused1"])
def test_port_matches_jax_engine_prefix_on(chunked, depth):
    """Four requests on one 40-token system prompt under a tight pool (so
    a prefix-shared victim recomputes): tables, tokens and the prefix
    counters are the JAX engine's, and sharing took place."""
    rng = np.random.RandomState(2)
    system = rand_tokens(rng, 40)
    prompts = [system + rand_tokens(rng, 4 + 2 * i) for i in range(4)]
    prompts += [rand_tokens(rng, 30)]
    ours, _ = lockstep(serve_kw(prefix=True, chunked=chunked, depth=depth),
                       prompts)
    assert ours.blocks.prefix_hit_tokens > 0


def test_forced_cow_copies_rows_and_counts_jax_bytes():
    """`_cow_blocks` on a pair: the destination's K, V and pos rows become
    the source's, the other blocks stay, and copy_bytes is what the JAX
    engine counts for the same pair."""
    from repro.config.base import ServeConfig as JServeConfig
    from repro.serving.engine import Engine as JEngine

    jcfg, jm, jp, _, _ = weights()
    kw = serve_kw(prefix=True)
    eng = engine(ServeConfig(**kw), **ENGINE_KW)
    g = torch.Generator().manual_seed(0)
    for k, v in eng.cache.items():
        if k == "pos":
            v.copy_(torch.randint(-1, 96, v.shape, generator=g,
                                  dtype=v.dtype))
        else:
            v.normal_(generator=g)
    before = {k: v.clone() for k, v in eng.cache.items()}
    eng._cow_blocks([(3, 7)])
    for k in ("k", "v", "pos"):
        ax = 0 if k == "pos" else 1
        got, was = eng.cache[k], before[k]
        assert torch.equal(got.select(ax, 7), was.select(ax, 3)), k
        keep = [i for i in range(got.shape[ax]) if i != 7]
        assert torch.equal(got.index_select(ax, torch.tensor(keep)),
                           was.index_select(ax, torch.tensor(keep))), k
    ref = JEngine(jm, jp, JServeConfig(**kw), **ENGINE_KW)
    ref._cow_blocks([(3, 7)])
    assert eng.copy_bytes == ref.copy_bytes > 0
    eng._cow_blocks([])
    assert eng.copy_bytes == ref.copy_bytes
