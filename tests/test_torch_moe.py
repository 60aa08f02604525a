"""The port's MoE layer (`models/layers.py` `moe_apply`, the JAX package's
GShard dense dispatch) and the MoE family in the engine, against the JAX
package with the same weights, reduced qwen2-moe-a2.7b, fp32 on the CPU,
at rtol = atol = 2e-4 (tests/test_torch_model.py).

* `moe_apply` at `no_drop` True and False, groups of 4, 16 and 128 tokens
  (a padded tail), with a row of zero tokens (exact router ties, which go
  to the lower expert as in `jax.lax.top_k`); the experts each token
  takes are the JAX package's, and a near tie fails loudly instead of
  being tolerated; the aux loss.
* no_drop group invariance (tests/test_invariances.py on the port).
* `ParamInit` takes the fan-in of an (E, d, f) stack as d, as `dense_init`
  does, and draws every 2-D weight as before; the router is fp32.
* Paged equals contiguous bit for bit; the engine with prefix sharing and
  with swap forced, stepped beside the JAX engine.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_archs import paged_tables
from test_torch_preemption import lockstep, serve_kw

from repro.config.registry import get_config as jax_config
from repro.models import layers as JL
from repro.models.model import build_model as jax_build
from repro_torch.config.registry import get_config
from repro_torch.models import layers as L
from repro_torch.models.model import build_model
from repro_torch.params import from_jax_params

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "qwen2-moe-a2.7b"
CFG, JCFG = get_config(ARCH, "reduced"), jax_config(ARCH, "reduced")
#: a router probability this close to the k-th largest is a near tie: the
#: two packages' sums may order it differently, so a test must not use it
TIE = 1e-6
_W = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many tiny ops: one intra-op thread serves them faster than a pool,
    and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def moe_params(seed=3):
    """One MoE block's params: the JAX package's and the port's copy."""
    if seed not in _W:
        jp = JL.init_moe(jax.random.PRNGKey(seed), JCFG, jnp.float32)
        _W[seed] = (jp, from_jax_params(jax.device_get(jp)))
    return _W[seed]


def model_weights():
    """(JAX config, JAX model, JAX params, port model, port params) of
    reduced qwen2-moe-a2.7b: `lockstep`'s layout."""
    if "model" not in _W:
        jm = jax_build(JCFG, dtype=jnp.float32)
        jp = jm.init(jax.random.PRNGKey(0))
        m = build_model(CFG, dtype=torch.float32, device="cpu")
        _W["model"] = (JCFG, jm, jp, m, from_jax_params(jax.device_get(jp)))
    return _W["model"]


def routing(router, x, group):
    """The JAX package's router on `x`: probs (nG, G, E) and the top-k
    experts (nG, G, K) of every token, the zero-padded tail included."""
    d = x.shape[-1]
    xf = x.reshape(-1, d)
    G = min(group, len(xf))
    xf = np.concatenate([xf, np.zeros(((-len(xf)) % G, d), np.float32)])
    probs = jax.nn.softmax(jnp.asarray(xf.reshape(-1, G, d)) @ router, -1)
    _, idx = jax.lax.top_k(probs, JCFG.moe.num_experts_per_tok)
    return np.asarray(probs), np.asarray(idx)


@pytest.mark.parametrize("group", [4, 16, 128])
@pytest.mark.parametrize("no_drop", [True, False], ids=["no_drop", "capacity"])
def test_moe_apply_matches_jax(no_drop, group):
    jp, p = moe_params()
    x = np.random.RandomState(group).randn(3, 50, CFG.d_model).astype(
        np.float32)
    x[1] = 0.0          # a row of zero tokens: every router prob ties
    K = CFG.moe.num_experts_per_tok
    probs, want_idx = routing(jp["router"], x, group)
    top = -np.sort(-probs, -1)
    ties = top[..., 0] == top[..., -1]      # zero tokens: all E probs equal
    assert ties.any()
    gap = (top[..., K - 1] - top[..., K])[~ties]
    assert gap.min() > TIE, f"a near tie in the router: gap {gap.min()}"
    _, got_idx = L.top_k(torch.tensor(probs), K)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)

    jy, jaux = JL.moe_apply(jp, jnp.asarray(x), JCFG, no_drop=no_drop,
                            group_size=group)
    y, aux = L.moe_apply(p, torch.from_numpy(x), CFG, no_drop=no_drop,
                         group_size=group)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    if not no_drop:
        # capacity dispatch drops choices here, so it is not no_drop's
        y0, _ = L.moe_apply(p, torch.from_numpy(x), CFG, no_drop=True,
                            group_size=group)
        assert not torch.allclose(y, y0, **TOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("group", [4, 8, 16, 32, 64])
def test_moe_no_drop_group_invariance(group, seed):
    """tests/test_invariances.py on the port: no_drop dispatch in groups of
    any size gives the one-group result."""
    _, p = moe_params()
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        2, 24, CFG.d_model).astype(np.float32))
    want, _ = L.moe_apply(p, x, CFG, no_drop=True, group_size=48)
    got, _ = L.moe_apply(p, x, CFG, no_drop=True, group_size=group)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_aux_loss_is_the_load_balance_term():
    """E x sum over experts of (share of tokens whose first choice it is) x
    (mean router prob), times the coefficient, as the JAX package's."""
    _, p = moe_params()
    x = torch.from_numpy(np.random.RandomState(7).randn(
        2, 9, CFG.d_model).astype(np.float32))
    _, aux = L.moe_apply(p, x, CFG)
    probs = torch.softmax(x.reshape(-1, CFG.d_model) @ p["router"], -1)
    E = CFG.moe.num_experts
    first = torch.bincount(probs.argmax(-1), minlength=E) / len(probs)
    want = E * (first * probs.mean(0)).sum() * CFG.moe.router_aux_loss_coef
    torch.testing.assert_close(aux, want, rtol=1e-6, atol=1e-9)


def test_top_k_breaks_ties_as_jax():
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [1, 1, 1, 1, 1],
                  [0.5, 0.1, 0.7, 0.7, 0.0]], np.float32)
    for k in (1, 2, 3):
        v, i = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = L.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(i))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(v))


def test_param_init_fan_in_and_router_dtype():
    """An (E, d, f) expert stack is drawn at 1/sqrt(d), as `dense_init`
    takes fan-in from shape[-2]; a 2-D weight is the same draw as before
    (1/sqrt(shape[0])); the router is drawn in fp32 under bf16 weights,
    and `from_jax_params` keeps it fp32."""
    init = L.ParamInit(5, torch.float32, "cpu")
    w = init.stacked(3, (8, 256, 64))
    assert abs(float(w.std()) - 1 / math.sqrt(256)) < 0.05 / math.sqrt(256)
    a = L.ParamInit(6, torch.float32, "cpu").stacked(2, (96, 40))
    g = torch.Generator().manual_seed(6)
    b = torch.empty(2, 96, 40)
    for i in range(2):
        b[i].normal_(0.0, 1 / math.sqrt(96), generator=g)
    assert torch.equal(a, b)
    p = build_model(CFG, torch.bfloat16, "cpu").init(0)
    moe = p["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].dtype == moe["shared"]["w_up"].dtype == torch.bfloat16
    assert moe["w_gate"].shape == (CFG.num_layers, CFG.moe.num_experts,
                                   CFG.d_model, CFG.moe.expert_ff_dim)
    jp = jax.device_get(model_weights()[2])
    q = from_jax_params(jp, dtype=torch.bfloat16)["layers"]["moe"]
    assert q["router"].dtype == torch.float32
    assert q["w_down"].dtype == torch.bfloat16


def test_moe_paged_equals_contiguous():
    """Ragged prefill (padding tokens in the dispatch groups) then decode:
    the paged pools give the contiguous cache's logits bit for bit."""
    *_, m, p = model_weights()
    rng = np.random.RandomState(0)
    lens, n_new = [12, 9, 5], 6
    B, T = len(lens), max(lens)
    toks = torch.zeros(B, T, dtype=torch.int64)
    pos = torch.full((B, T), -1, dtype=torch.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = torch.from_numpy(rng.randint(0, CFG.vocab_size, n))
        pos[i, :n] = torch.arange(n)
    cache_c = m.init_cache(B, 64)
    cache_p, tables = paged_tables(m, [n + n_new for n in lens], 64)
    lg_c, cache_c = m.prefill(p, toks, pos, cache_c)
    lg_p, cache_p = m.prefill_paged(p, toks, pos, tables, cache_p)
    assert torch.equal(lg_c, lg_p)
    cur = list(lens)
    nxt = [int(lg_c[i, n - 1].argmax()) for i, n in enumerate(lens)]
    for _ in range(n_new):
        tt, sl = torch.tensor(nxt), torch.tensor(cur, dtype=torch.int32)
        lg_c, cache_c = m.decode_step(p, tt, sl, cache_c)
        lg_p, cache_p = m.decode_step_paged(p, tt, sl, tables, cache_p)
        assert torch.equal(lg_c, lg_p)
        nxt = [int(x) for x in lg_c.argmax(-1)]
        cur = [c + 1 for c in cur]


def _prompts(seed, lens, system=0):
    rng = np.random.RandomState(seed)
    head = list(map(int, rng.randint(0, CFG.vocab_size, size=system)))
    return [head + list(map(int, rng.randint(0, CFG.vocab_size, size=n)))
            for n in lens]


def test_moe_engine_matches_jax_engine_prefix_on():
    """Four requests on one 40-token system prompt and one other under a
    tight pool, chunked on two lanes: tables after every step, tokens and
    the prefix counters are the JAX engine's, and sharing took place."""
    prompts = _prompts(2, (4, 6, 8, 10), system=40) + _prompts(3, (30,))
    ours, _ = lockstep(serve_kw(prefix=True), prompts, w=model_weights())
    assert ours.blocks.prefix_hit_tokens > 0


def test_moe_engine_matches_jax_engine_swap_forced():
    """Forced swap under a tight pool: tables, swap ledgers, tokens and the
    swap counters are the JAX engine's."""
    ours, _ = lockstep(serve_kw(swap=32, preempt="swap"),
                       _prompts(1, (40, 44, 38, 46, 9)), w=model_weights())
    assert ours.swap_outs > 0 and ours.swap_ins == ours.swap_outs
