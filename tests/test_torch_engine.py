"""The port's engine against the JAX package's `Engine`, with the same
weights, on the setups of tests/test_engine.py and
tests/test_multilane_prefill.py (reduced granite-3-8b, fp32, CPU).

Each setup runs the JAX engine once on its contiguous cache and the port in
both cache layouts: greedy tokens must be identical, and so must the
structural counters, which depend on the scheduler alone (no EOS).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import ServeConfig as JServeConfig
from repro.config.registry import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.serving.engine import Engine as JEngine
from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.models.model import build_model
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import Engine

COUNTERS = ("decode_steps", "mean_batch", "admitted", "preemptions",
            "prefill_tokens", "finished")


def _prompts(seed, n, lo, hi, vocab):
    rng = np.random.RandomState(seed)
    if lo == hi:
        return [list(map(int, rng.randint(0, vocab, size=lo)))
                for _ in range(n)]
    return [list(map(int, rng.randint(0, vocab, size=rng.randint(lo, hi))))
            for _ in range(n)]


#: name -> (ServeConfig kwargs, Engine kwargs, prompts (seed, n, lo, hi),
#:          max_new_tokens)
SETUPS = {
    # test_engine.test_batched_equals_unbatched
    "static": (dict(policy="static", b_max=4, max_new_tokens=6,
                    kv_pool_tokens=2048),
               dict(max_context=64, buckets=(1, 2, 4), prefill_chunk=8),
               (0, 4, 4, 20), 6),
    "memory": (dict(policy="memory", b_max=4, max_new_tokens=6,
                    kv_pool_tokens=2048),
               dict(max_context=64, buckets=(1, 2, 4), prefill_chunk=8),
               (0, 4, 4, 20), 6),
    # test_engine.test_preemption_recovers_and_completes: static admission
    # over-commits a 12-block pool and must preempt (recompute)
    "static-preempt": (dict(policy="static", b_max=8, max_new_tokens=40,
                            kv_pool_tokens=192, block_size=16),
                       dict(max_context=64, buckets=(1, 2, 4, 8),
                            prefill_chunk=8),
                       (1, 6, 10, 10), 40),
    # test_multilane_prefill.make_engine, PD fusion with 1 and 2 lanes
    "chunked-1-lane": (dict(policy="memory", b_max=6, max_new_tokens=5,
                            kv_pool_tokens=4096, chunked_prefill=True,
                            chunk_budget_tokens=16, n_prefill_lanes=1),
                       dict(max_context=64, buckets=(1, 2, 4, 8),
                            prefill_chunk=8),
                       (0, 6, 6, 40), 5),
    "chunked-2-lanes": (dict(policy="memory", b_max=6, max_new_tokens=5,
                             kv_pool_tokens=4096, chunked_prefill=True,
                             chunk_budget_tokens=16, n_prefill_lanes=2),
                        dict(max_context=64, buckets=(1, 2, 4, 8),
                             prefill_chunk=8),
                        (0, 6, 6, 40), 5),
}


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_config("granite-3-8b", "reduced")
    jm = jax_build(jcfg, dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(get_config("granite-3-8b", "reduced"),
                    dtype=torch.float32, device="cpu")
    return jcfg, jm, jp, m, from_jax_params(jax.device_get(jp))


def _serve(eng, prompts, max_new):
    hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run(max_steps=5000)
    return [h.output_tokens for h in hs], eng.summary()


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_engine_matches_jax_engine(weights, setup):
    jcfg, jm, jp, m, p = weights
    serve_kw, eng_kw, (seed, n, lo, hi), max_new = SETUPS[setup]
    prompts = _prompts(seed, n, lo, hi, jcfg.vocab_size)
    want, jsum = _serve(JEngine(jm, jp, JServeConfig(**serve_kw), **eng_kw),
                        prompts, max_new)
    assert jsum["finished"] == n
    for paged in (False, True):
        got, s = _serve(Engine(m, p, ServeConfig(paged_kv=paged, **serve_kw),
                               device="cpu", **eng_kw), prompts, max_new)
        assert got == want, (setup, paged)
        assert {k: s[k] for k in COUNTERS} == {k: jsum[k] for k in COUNTERS}
        assert s["copy_rows"] == (0.0 if paged else jsum["copy_rows"])
        assert set(s) == set(jsum)
    if setup == "static-preempt":
        assert jsum["preemptions"] > 0


def test_engine_telemetry_feeds_policy(weights):
    """test_engine.test_engine_telemetry_feeds_policy on the port."""
    jcfg, _, _, m, p = weights
    serve = ServeConfig(policy="memory", b_max=8, max_new_tokens=4,
                        kv_pool_tokens=2048)
    eng = Engine(m, p, serve, max_context=64, buckets=(1, 2, 4, 8),
                 prefill_chunk=8, device="cpu")
    for prompt in _prompts(3, 3, 6, 6, jcfg.vocab_size):
        eng.submit(prompt)
    eng.run()
    s = eng.summary()
    assert s["finished"] == 3 and s["decode_steps"] > 0
    assert s["tbt_ms_mean"] > 0 and len(eng.tel.tbt) > 0


def test_block_manager_matches_jax():
    """The port's trimmed allocator makes the JAX allocator's decisions,
    block id for block id, over a random allocate/free sequence."""
    from repro.serving.kv_cache import BlockManager as JBlockManager
    from repro_torch.serving.kv_cache import BlockManager

    rng = np.random.RandomState(0)
    ours, ref = BlockManager(512, 16), JBlockManager(512, 16)
    for _ in range(300):
        rid = int(rng.randint(8))
        if rng.rand() < 0.3:
            assert ours.free(rid) == ref.free(rid)
        else:
            cur, new = int(rng.randint(64)), int(rng.randint(1, 40))
            assert ours.allocate(rid, cur, new) == ref.allocate(rid, cur, new)
        assert ours.table(rid) == ref.tables.get(rid, [])
        assert ours.free_blocks == ref.free_blocks
        n = int(rng.randint(40))
        assert ours.admission_verdict(n, 8) == ref.admission_verdict(n, 8)
