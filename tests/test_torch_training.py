"""The port's training forward and loss against the JAX package's, with the
same weights (`params.from_jax_params`), reduced configs in fp32 on the CPU.

* For all six families (and recurrentgemma at 5 layers with a 16-token
  window: one whole pattern group, then two recurrent layers unrolled):
  `forward_train` logits at rtol = atol = 2e-4 (tests/test_consistency.py),
  `loss_fn`'s ce and aux at rtol 1e-5, and every gradient leaf within
  2e-4 x max|g_jax| + 1e-6. The VLM's cross gates are set to 0.5: at their
  initial 0 the cross branch would pass no gradient to its weights.
* remat on equals remat off bit for bit, loss and every gradient.
* A loss chunk shorter than T - 1 (the last chunk padded) with a random
  `loss_mask`; qwen2-moe with capacity drops and its aux loss.
* The guard: forward_train plus backward with every public entry of
  `kernels.ops` patched to raise, so training never reaches a kernel.
* The plain recurrences pass `torch.autograd.gradcheck`.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import TrainConfig as JTrainConfig
from repro.config.registry import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.training.data import MarkovData as JMarkovData
from repro_torch.config.registry import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.model import build_model
from repro_torch.params import from_jax_params, named_leaves
from repro_torch.training.train_loop import trainable, value_and_grad

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("granite-3-8b", "qwen2-moe-a2.7b", "mamba2-2.7b",
         "recurrentgemma-9b", "llama-3.2-vision-90b", "seamless-m4t-medium")
#: (arch, config changes): the six families, and the hybrid with a
#: pattern remainder and a window shorter than the sequence
CASES = [(a, ()) for a in ARCHS] + [("recurrentgemma-9b", (
    ("num_layers", 5), ("window_size", 16)))]
#: 40 tokens: mamba2's 32-token SSD chunks pad the second one
B_, T_ = 2, 40


def case_id(case):
    arch, changes = case
    return arch + "".join(f"-{k}{v}" for k, v in changes)


def configs(arch, changes=()):
    """The JAX and port configs of `arch` (reduced) with `changes`."""
    out = []
    for cfg in (jax_config(arch, "reduced"), get_config(arch, "reduced")):
        for k, v in changes:
            if k == "window_size":
                cfg = dataclasses.replace(cfg, rglru=dataclasses.replace(
                    cfg.rglru, window_size=v))
            elif k == "capacity_factor":
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=v))
            else:
                cfg = dataclasses.replace(cfg, **{k: v})
        out.append(cfg)
    return out


@functools.lru_cache(maxsize=None)
def setup(arch, changes=(), seed=0):
    """(JAX model, JAX params, port model, port params, numpy batch): the
    same weights in both, the VLM's gates at 0.5, one MarkovData batch."""
    jcfg, cfg = configs(arch, changes)
    jm = jax_build(jcfg, dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(seed))
    if "cross_layers" in jp:
        attn = jp["cross_layers"]["attn"]
        attn["gate"] = jnp.full_like(attn["gate"], 0.5)
    m = build_model(cfg, dtype=torch.float32, device="cpu")
    p = trainable(from_jax_params(jax.device_get(jp)))
    batch = next(JMarkovData(jcfg, JTrainConfig(
        global_batch=B_, seq_len=T_, seed=seed)).batches())
    return jm, jp, m, p, batch


def port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_reference(arch, changes=()):
    """JAX's logits, loss metrics and gradients (numpy), remat off, from
    one jitted function."""
    jm, jp, _, _, batch = setup(arch, changes)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(q):
        logits, _ = jm.forward_train(q, jb, remat=False)
        loss, met = jm.loss_fn(q, jb, remat=False)
        return loss, (logits, met)

    (_, (logits, met)), grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(jp)
    return jax.device_get((logits, met, grads))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops: one intra-op thread, so parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_forward_train_logits_match_jax(case):
    _, _, m, p, batch = setup(*case)
    want, _, _ = jax_reference(*case)
    with torch.no_grad():
        got, _ = m.forward_train(p, port_batch(batch), remat=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_loss_and_grads_match_jax(case):
    _, _, m, p, batch = setup(*case)
    _, met, want = jax_reference(*case)
    loss, got_met, got = value_and_grad(m, p, port_batch(batch),
                                        remat=False)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(got_met[k]), float(met[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss), float(met["ce"] + met["aux"]),
                               rtol=1e-5)
    names = [n for n, _ in named_leaves(want)]
    assert names == [n for n, _ in named_leaves(got)]
    for (name, w), (_, g) in zip(named_leaves(want), named_leaves(got)):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= 2e-4 * np.abs(w).max() + 1e-6, (name, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_for_bit(arch):
    _, _, m, p, batch = setup(arch)
    tb = port_batch(batch)
    l0, met0, g0 = value_and_grad(m, p, tb, remat=False)
    l1, met1, g1 = value_and_grad(m, p, tb, remat=True)
    assert torch.equal(l0, l1) and torch.equal(met0["aux"], met1["aux"])
    for (name, a), (_, b) in zip(named_leaves(g0), named_leaves(g1)):
        assert torch.equal(a, b), name


def test_loss_chunks_and_mask_match_jax():
    """loss_chunk 7 over T - 1 = 39 predicting positions (6 chunks, the
    last padded by 3) with a random 0/1 loss_mask; the same loss as one
    chunk."""
    jm, jp, m, p, batch = setup("granite-3-8b")
    batch = dict(batch, loss_mask=np.random.RandomState(5).randint(
        0, 2, (B_, T_)).astype(np.int32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, wmet = jax.jit(lambda q: jm.loss_fn(q, jb, remat=False,
                                              loss_chunk=7))(jp)
    with torch.no_grad():
        got, met = m.loss_fn(p, port_batch(batch), remat=False,
                             loss_chunk=7)
        whole, _ = m.loss_fn(p, port_batch(batch), remat=False)
    np.testing.assert_allclose(float(met["ce"]), float(wmet["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(whole), rtol=1e-6)


def test_moe_capacity_drops_match_jax():
    """qwen2-moe at capacity factor 0.5 (20 slots an expert for 160
    picks of 4 experts): picks are dropped, and the loss, aux loss and
    gradients still match JAX's."""
    case = ("qwen2-moe-a2.7b", (("capacity_factor", 0.5),))
    _, _, m, p, batch = setup(*case)
    _, met, want = jax_reference(*case)
    cfg = m.cfg
    C = L.moe_capacity(B_ * T_, cfg, no_drop=False)
    assert C * cfg.moe.num_experts < B_ * T_ * cfg.moe.num_experts_per_tok
    assert float(met["aux"]) > 0
    _, got_met, got = value_and_grad(m, p, port_batch(batch), remat=False)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(got_met[k]), float(met[k]),
                                   rtol=1e-5, err_msg=k)
    for (name, w), (_, g) in zip(named_leaves(want), named_leaves(got)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() \
            <= 2e-4 * np.abs(w).max() + 1e-6, name


@pytest.mark.parametrize("arch", ARCHS)
def test_training_never_reaches_a_kernel(arch, monkeypatch):
    """Every public entry of `kernels.ops` raises: forward_train and its
    backward still run (remat on, so the recomputation too), and every
    leaf gets a gradient."""
    def refuse(*a, **k):
        raise AssertionError("training reached kernels.ops")

    for name in dir(ops):
        fn = getattr(ops, name)
        if not name.startswith("_") and callable(fn) \
                and getattr(fn, "__module__", "") == ops.__name__ \
                and name != "reset_launches":
            monkeypatch.setattr(ops, name, refuse)
    _, _, m, p, batch = setup(arch)
    loss, _, grads = value_and_grad(m, p, port_batch(batch), remat=True)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for _, g in named_leaves(grads))
    # the serving path does reach the patched entries
    tb = port_batch(batch)
    extras = {k: v for k, v in tb.items() if k != "tokens"}
    with pytest.raises(AssertionError, match="kernels.ops"):
        m.prefill(p, tb["tokens"][:, :4], torch.arange(
            4, dtype=torch.int32).repeat(B_, 1), m.init_cache(
            B_, 8, enc_len=64), extras=extras or None)


@pytest.mark.filterwarnings("ignore:Input #:UserWarning")
def test_plain_recurrences_pass_gradcheck():
    """The SSD chunked scan (a padded second chunk, the per-chunk state
    loop) and the gated RG-LRU recurrence (a loop over time into a
    stacked output) under autograd, against finite differences in fp32."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).requires_grad_()

    x, Bm, Cm = rnd(1, 6, 2, 3), rnd(1, 6, 4), rnd(1, 6, 4)
    dt = (torch.rand(1, 6, 2, generator=g) * 0.5 + 0.1).requires_grad_()
    A = torch.tensor([-1.0, -3.0])
    # fp32 inputs (the plain versions compute in fp32 whatever they get)
    opts = dict(eps=1e-3, atol=2e-3, rtol=2e-2)
    assert torch.autograd.gradcheck(
        lambda *a: S.ssd_chunked_train(*a[:2], A, *a[2:], chunk=4)[0],
        (x, dt, Bm, Cm), **opts)
    ga, gi, xr = rnd(2, 5, 3), rnd(2, 5, 3), rnd(2, 5, 3)
    lam, b_a, b_i = rnd(3), rnd(3, scale=0.1), rnd(3, scale=0.1)
    h0 = rnd(2, 3)
    assert torch.autograd.gradcheck(
        lambda *a: ref.rglru_gated_scan_ref(*a)[0],
        (ga, gi, xr, lam, b_a, b_i, h0), **opts)


def test_ssd_gradient_survives_strong_decay():
    """At full width's decay (80 heads, A down to -80, a 256-token chunk)
    the within-chunk differences above the diagonal overflow exp; the
    plain SSD masks before the exp, so the gradient stays finite."""
    H, Q = 4, 256
    x = torch.randn(1, Q, H, 2, requires_grad=True)
    dt = torch.full((1, Q, H), 0.5, requires_grad=True)
    A = -torch.tensor([1.0, 20.0, 50.0, 80.0])
    Bm, Cm = torch.randn(2, 1, Q, 3).unbind(0)
    y, h = S.ssd_chunked_train(x, dt, A, Bm, Cm, chunk=Q)
    (y.sum() + h.sum()).backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(dt.grad).all()
