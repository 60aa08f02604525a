"""The port's engine against the JAX package's `Engine` on the stateful
families (reduced mamba2-2.7b and recurrentgemma-9b, fp32, CPU, the same
weights): greedy tokens and structural counters equal in both cache
layouts under `static` and `memory` with chunked prefill on two lanes, and
the state-only long-decode regression of tests/test_paged_kv.py.
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
from test_torch_engine import COUNTERS, _prompts, _serve

FAMILIES = ["mamba2-2.7b", "recurrentgemma-9b"]


@pytest.fixture(scope="module", params=FAMILIES)
def weights(request):
    jcfg = jax_config(request.param, "reduced")
    jm = jax_build(jcfg, dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(get_config(request.param, "reduced"),
                    dtype=torch.float32, device="cpu")
    return jcfg, jm, jp, m, from_jax_params(jax.device_get(jp))


@pytest.mark.parametrize("policy", ["static", "memory"])
def test_engine_matches_jax_engine(weights, policy):
    """PD fusion on two lanes (lane gather/scatter, promotion copies in
    the contiguous layout, pinned state slots in the paged one)."""
    jcfg, jm, jp, m, p = weights
    serve_kw = dict(policy=policy, b_max=6, max_new_tokens=5,
                    kv_pool_tokens=4096, chunked_prefill=True,
                    chunk_budget_tokens=16, n_prefill_lanes=2)
    eng_kw = dict(max_context=64, buckets=(1, 2, 4, 8), prefill_chunk=8)
    prompts = _prompts(0, 6, 6, 40, jcfg.vocab_size)
    want, jsum = _serve(JEngine(jm, jp, JServeConfig(**serve_kw), **eng_kw),
                        prompts, 5)
    assert jsum["finished"] == 6
    for paged in (False, True):
        got, s = _serve(Engine(m, p, ServeConfig(paged_kv=paged, **serve_kw),
                               device="cpu", **eng_kw), prompts, 5)
        assert got == want, paged
        assert {k: s[k] for k in COUNTERS} == {k: jsum[k] for k in COUNTERS}
        assert s["copy_rows"] == (0.0 if paged else jsum["copy_rows"])
        assert s["copy_bytes"] == (0.0 if paged else jsum["copy_bytes"])


@pytest.mark.parametrize("paged", [False, True])
def test_ssm_long_decode_no_spurious_preemptions(paged):
    """tests/test_paged_kv.py's regression on the port: a state-only family
    holds one block per request, so a long decode on a 4-block pool
    finishes with 0 preemptions and the allocator back at full."""
    cfg = get_config("mamba2-2.7b", "reduced")
    assert cfg.kv_bytes_per_token() == 0
    m = build_model(cfg, torch.float32, "cpu")
    rng = np.random.RandomState(0)
    serve = ServeConfig(policy="static", b_max=4, max_new_tokens=56,
                        kv_pool_tokens=64, block_size=16, paged_kv=paged)
    eng = Engine(m, m.init(0), serve, max_context=64, buckets=(1, 2, 4),
                 prefill_chunk=8, device="cpu")
    hs = [eng.submit(list(map(int, rng.randint(0, cfg.vocab_size, 6))),
                     max_new_tokens=56) for _ in range(3)]
    eng.run(max_steps=2000)
    assert eng.total_finished == 3
    assert all(len(h.output_tokens) == 56 for h in hs)
    assert eng.preemptions == 0
    assert eng.blocks.free_blocks == eng.blocks.num_blocks
