"""The port's training substrate against the JAX package's, on the CPU:
MarkovData bit for bit, the learning-rate schedule, clipping and one
AdamW update on identical inputs, five train steps beside JAX's, the
checkpoint format both ways, the loop and the CLI (the twins of
tests/test_training.py).

Five steps at lr 3e-3 from the same params and batches: the losses agree
within rtol 2e-5 and every param within 1e-3 of JAX's (measured: 1.5e-7
and 9.9e-5 for granite, 5.3e-6 and 6.2e-4 for qwen2-moe, whose router
picks are discontinuous; the first Adam steps are nearly sign(g), so a
gradient near zero can move a param the other way).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import TrainConfig as JTrainConfig
from repro.config.registry import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training.data import MarkovData as JMarkovData
from repro.training.train_loop import make_train_step as jax_train_step
from repro_torch.config.base import TrainConfig
from repro_torch.config.registry import get_config
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build_model
from repro_torch.params import (from_jax_opt_state, from_jax_params,
                                named_leaves)
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.data import MarkovData
from repro_torch.training.optimizer import (adamw_init, adamw_update,
                                            global_norm, lr_schedule)
from repro_torch.training.train_loop import (make_train_step, to_device,
                                             train, trainable)

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("granite-3-8b", "qwen2-moe-a2.7b", "mamba2-2.7b",
         "recurrentgemma-9b", "llama-3.2-vision-90b", "seamless-m4t-medium")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(arch, seed=0):
    """The JAX model and params, and the port's with the same weights."""
    jm = jax_build(jax_config(arch, "reduced"), dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(seed))
    m = build_model(get_config(arch, "reduced"), dtype=torch.float32,
                    device="cpu")
    return jm, jp, m, trainable(from_jax_params(jax.device_get(jp)))


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_markov_data_matches_jax_bit_for_bit(arch):
    kw = dict(global_batch=3, seq_len=17, seed=4)
    ours = MarkovData(get_config(arch, "reduced"), TrainConfig(**kw))
    theirs = JMarkovData(jax_config(arch, "reduced"), JTrainConfig(**kw))
    np.testing.assert_array_equal(ours.next_tokens, theirs.next_tokens)
    for a, b in zip([next(ours.batches()) for _ in range(2)],
                    [next(theirs.batches()) for _ in range(2)]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("warmup,steps", [(10, 100), (0, 7), (20, 20)])
def test_lr_schedule_matches_jax(warmup, steps):
    kw = dict(steps=steps, warmup_steps=warmup, lr=1e-3)
    t, jt = TrainConfig(**kw), JTrainConfig(**kw)
    ours = [float(lr_schedule(torch.tensor(s, dtype=torch.int32), t))
            for s in range(steps + 3)]
    theirs = [float(jopt.lr_schedule(jnp.asarray(s, jnp.int32), jt))
              for s in range(steps + 3)]
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-12)
    if warmup == 10:  # the shape tests/test_training.py asserts
        assert ours[5] < ours[10] and max(ours) <= 1e-3 + 1e-9
        assert ours[-1] < ours[21]


def _update_case(seed=0):
    """Params (fp32, an fp32-kept `lam`, a bf16 leaf), gradients, moments
    and a step, as numpy."""
    rng = np.random.RandomState(seed)
    shapes = {"w": (6, 5), "lam": (5,), "emb": (4, 3)}
    p = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (rng.randn(*s) * 0.3).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: (rng.randn(*s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: (rng.rand(*s) * 0.01).astype(np.float32)
         for k, s in shapes.items()}
    return p, g, m, v


@pytest.mark.parametrize("clip", [1.0, 0.0, 1e3])
def test_adamw_update_matches_jax(clip):
    """One update on identical params, grads, m, v and step 7: params and
    moments within 1e-6 relative of JAX's (the bf16 leaf within one bf16
    ulp: its fp32 update is rounded once more), lr and the global norm
    too."""
    kw = dict(lr=2e-2, warmup_steps=3, steps=20, grad_clip=clip,
              weight_decay=0.1)
    p, g, m, v = _update_case()
    jp = {k: jnp.asarray(a, jnp.bfloat16 if k == "emb" else jnp.float32)
          for k, a in p.items()}
    jstate = {"m": {k: jnp.asarray(a) for k, a in m.items()},
              "v": {k: jnp.asarray(a) for k, a in v.items()},
              "step": jnp.asarray(7, jnp.int32)}
    wp, wstate, wmet = jopt.adamw_update(
        jp, {k: jnp.asarray(a) for k, a in g.items()}, jstate,
        JTrainConfig(**kw))
    tp = {k: torch.from_numpy(a).to(torch.bfloat16 if k == "emb"
                                    else torch.float32)
          for k, a in p.items()}
    state = from_jax_opt_state(jax.device_get(jstate))
    gp, gstate, met = adamw_update(
        trainable(tp), {k: torch.from_numpy(a) for k, a in g.items()},
        state, TrainConfig(**kw))
    assert int(gstate["step"]) == 8 and gstate["step"].dtype == torch.int32
    np.testing.assert_allclose(float(met["lr"]), float(wmet["lr"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(wmet["grad_norm"]), rtol=1e-6)
    for k in p:
        want = np.asarray(wp[k].astype(jnp.float32))
        assert gp[k].dtype == tp[k].dtype and gp[k].requires_grad
        tol = 2.0 ** -8 if k == "emb" else 1e-6
        np.testing.assert_allclose(gp[k].detach().float().numpy(), want,
                                   rtol=tol, atol=tol * np.abs(want).max())
        for mom in ("m", "v"):
            w = np.asarray(wstate[mom][k])
            np.testing.assert_allclose(gstate[mom][k].numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())


def test_grad_clip_bounds_update_as_jax():
    """tests/test_training.py's clip case on the port, and the same numbers
    as JAX's."""
    t = TrainConfig(grad_clip=1.0, lr=1.0, warmup_steps=0, steps=1)
    params = trainable({"w": torch.zeros(4)})
    p2, _, met = adamw_update(params, {"w": torch.full((4,), 100.0)},
                              adamw_init(params), t)
    assert float(met["grad_norm"]) > 100.0
    assert bool((p2["w"].abs() < 10.0).all())
    jp2, _, _ = jopt.adamw_update(
        {"w": jnp.zeros((4,))}, {"w": jnp.full((4,), 100.0)},
        jopt.adamw_init({"w": jnp.zeros((4,))}),
        JTrainConfig(grad_clip=1.0, lr=1.0, warmup_steps=0, steps=1))
    np.testing.assert_allclose(p2["w"].detach().numpy(),
                               np.asarray(jp2["w"]), rtol=1e-6)
    assert float(global_norm({"a": torch.full((4,), 3.0),
                              "b": {"c": torch.full((4,), 4.0)}})) == 10.0


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2-moe-a2.7b"])
def test_train_steps_match_jax(arch):
    """Five steps of `make_train_step` beside JAX's, from the same params
    and batches (tolerances in the module docstring)."""
    kw = dict(global_batch=2, seq_len=32, steps=5, lr=3e-3, warmup_steps=1)
    jm, jp, m, p = pair(arch)
    jstep = jax.jit(jax_train_step(jm, JTrainConfig(**kw)))
    step = make_train_step(m, TrainConfig(**kw))
    jo, o = jopt.adamw_init(jp), adamw_init(p)
    it = JMarkovData(jm.cfg, JTrainConfig(**kw)).batches()
    for _ in range(5):
        b = next(it)
        jp, jo, jmet = jstep(jp, jo, jax_batch(b))
        p, o, met = step(p, o, to_device(b, "cpu"))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=2e-5)
    assert int(o["step"]) == 5
    for (name, w), (_, g) in zip(named_leaves(jax.device_get(jp)),
                                 named_leaves(p)):
        assert np.abs(g.detach().numpy() - np.asarray(w)).max() < 1e-3, name


def test_loss_decreases_dense():
    """tests/test_training.py's learning test on the port."""
    m = build_model(get_config("granite-3-8b", "reduced"),
                    dtype=torch.float32, device="cpu")
    t = TrainConfig(global_batch=8, seq_len=64, steps=50, lr=3e-3,
                    warmup_steps=10, log_every=100)
    res = train(m, t, log=None)
    first = sum(res["losses"][:5]) / 5
    last = sum(res["losses"][-5:]) / 5
    assert last < first - 0.5, (first, last)
    assert len(res["step_ms"]) == 50 and res["tokens_per_s"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_bit_for_bit(tmp_path, dtype):
    m = build_model(get_config("starcoder2-7b", "reduced"), dtype=dtype,
                    device="cpu")
    params = trainable(m.init(0))
    opt = adamw_init(params)
    for _, x in named_leaves(opt["m"]):
        x.normal_()
    opt["step"] += 7
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, params, opt, step=7)
    p2, o2, step = load_checkpoint(path, params, adamw_init(params))
    assert step == 7 and int(o2["step"]) == 7
    for (name, a), (_, b) in zip(named_leaves({"p": params, "o": opt}),
                                 named_leaves({"p": p2, "o": o2})):
        assert a.dtype == b.dtype and a.requires_grad == b.requires_grad
        assert torch.equal(a, b), name


def test_jax_checkpoint_loads_into_port(tmp_path):
    """JAX takes a step and saves (fp32); the port loads params, moments
    and step and takes the next two steps: their losses are JAX's within
    1e-5 (the second one's params come from the loaded moments)."""
    kw = dict(global_batch=2, seq_len=32, steps=6, lr=3e-3, warmup_steps=2)
    jm, jp, m, _ = pair("granite-3-8b", seed=1)
    jstep = jax.jit(jax_train_step(jm, JTrainConfig(**kw)))
    it = JMarkovData(jm.cfg, JTrainConfig(**kw)).batches()
    batches = [next(it) for _ in range(3)]
    jo = jopt.adamw_init(jp)
    jp, jo, _ = jstep(jp, jo, jax_batch(batches[0]))
    path = os.path.join(tmp_path, "jax.npz")
    jckpt.save_checkpoint(path, jp, jo, step=1)
    like = trainable(m.init(0))
    p, o, step = load_checkpoint(path, like, adamw_init(like))
    assert step == 1 and int(o["step"]) == 1
    port_step = make_train_step(m, TrainConfig(**kw))
    for b in batches[1:]:
        jp, jo, jmet = jstep(jp, jo, jax_batch(b))
        p, o, met = port_step(p, o, to_device(b, "cpu"))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)


def test_train_writes_a_checkpoint_of_its_state(tmp_path):
    m = build_model(get_config("mamba2-2.7b", "reduced"),
                    dtype=torch.float32, device="cpu")
    t = TrainConfig(global_batch=2, seq_len=16, steps=2, warmup_steps=1)
    path = str(tmp_path / "run.npz")
    res = train(m, t, log=None, checkpoint_path=path)
    p, o, step = load_checkpoint(path, res["params"], res["opt_state"])
    assert step == 2 and int(o["step"]) == 2
    for (_, a), (_, b) in zip(named_leaves(res["params"]),
                              named_leaves(p)):
        assert torch.equal(a, b)


def test_train_cli_on_the_cpu_and_its_refusal(capsys):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--seq", "16"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "step     1 loss" in out.stdout and "final loss" in out.stdout
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--steps", "1"])
