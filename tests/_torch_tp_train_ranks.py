"""Rank processes of tests/test_torch_tp_training.py.

    PYTHONPATH=src python tests/_torch_tp_train_ranks.py

Trains the port's six families (reduced granite-3-8b, qwen2-moe-a2.7b,
mamba2-2.7b, recurrentgemma-9b, llama-3.2-vision-90b and
seamless-m4t-medium, fp32, remat on) for one step in 2 gloo ranks on a
(1, 2) mesh (`launch.mesh.spawn_ranks`), and on one device in each rank
from the same whole weights (`_torch_tp_ranks.numpy_params`) and batch,
and prints one line `RESULT<json>`: per family, each rank's loss beside
the one-device loss, the largest gap of any leaf's gradient from the
rank's slice of the one-device gradient (in units of that leaf's
max|g|), and after one AdamW step the gaps of its first moment (the
clipped gradient: the clip reads the global norm over the group) and of
its params where |g| is above 1e-3 of the leaf's max (the first step
moves each param by lr·sign(g), which a gradient near 0 may flip within
the gradient's own rounding). "planted" repeats
granite with `TensorParallel.copy` made the identity in its backward
too, so the gradients of the replicated leaves miss the other rank's
part: the gaps of its norm weights are reported. "one_rank": granite on a
(1, 1) gloo group, whose loss and gradients must be the no-group step's
bit for bit.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch
import torch.distributed as dist

from _torch_tp_ranks import numpy_params
from repro_torch.config.base import TrainConfig
from repro_torch.config.registry import get_config
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_serving_group, spawn_ranks
from repro_torch.models.model import build_model
from repro_torch.params import from_jax_params, named_leaves
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import (make_train_step, trainable,
                                             value_and_grad)

ARCHS = ("granite-3-8b", "qwen2-moe-a2.7b", "mamba2-2.7b",
         "recurrentgemma-9b", "llama-3.2-vision-90b", "seamless-m4t-medium")
MESH = (1, 2)
B, T, ENC = 2, 16, 8
TCFG = TrainConfig(global_batch=B, seq_len=T, steps=4, lr=1e-2,
                   warmup_steps=1, grad_clip=1.0)


def batch_of(cfg, seed: int = 0):
    """Tokens (B, T) and the family's extras, drawn with numpy."""
    rng = np.random.RandomState(seed)
    out = {"tokens": torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32))}
    key = {"vlm": "images", "encdec": "enc_frames"}.get(cfg.family.value)
    if key:
        out[key] = torch.from_numpy(
            rng.standard_normal((B, ENC, cfg.d_model)).astype(np.float32))
    return out


def gaps(got, want, where=None) -> dict:
    """Per leaf, max|got - want| / max|want| (want: the one-device tree,
    already cut to this rank's slices), over the elements `where` (a tree
    of masks) is true."""
    w = dict(named_leaves(want))
    masks = dict(named_leaves(where)) if where is not None else {}
    out = {}
    for name, g in named_leaves(got):
        d = (g - w[name]).abs()
        if name in masks:
            d = torch.where(masks[name], d, 0.0)
        out[name] = float(d.max() / w[name].abs().max().clamp_min(1e-30))
    return out


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def fresh(tree):
    """A trainable copy (the AdamW step writes its params in place)."""
    return trainable({k: fresh(v) if isinstance(v, dict) else v.clone()
                      for k, v in tree.items()})


def step_both(arch: str, group):
    """One device's loss, gradient and AdamW step, and the rank's."""
    cfg = get_config(arch, "reduced")
    whole = from_jax_params(numpy_params(cfg))
    batch = batch_of(cfg)
    one = build_model(cfg, torch.float32, "cpu")
    loss1, _, g1 = value_and_grad(one, fresh(whole), batch)
    p1, o1, _ = make_train_step(one, TCFG)(fresh(whole), adamw_init(whole),
                                           batch)
    model = build_model(cfg, torch.float32, "cpu", group=group)
    loss, _, g = value_and_grad(model, fresh(model.shard(whole)), batch)
    mine = fresh(model.shard(whole))
    p2, o2, _ = make_train_step(model, TCFG)(mine, adamw_init(mine), batch)
    g1 = model.shard(g1)
    firm = _map(lambda x: x.abs() > 1e-3 * x.abs().max(), g1)
    return dict(loss=float(loss), loss_one=float(loss1),
                grad_gaps=gaps(g, g1),
                moment_gaps=gaps(o2["m"], model.shard(o1["m"])),
                param_gaps=gaps(p2, model.shard(p1), firm))


def rank_main(rank, world):
    torch.manual_seed(0)
    torch.set_num_threads(1)
    group = make_serving_group(MESH, "gloo", rank, world)
    out = {}
    for arch in ARCHS:
        t0 = time.perf_counter()
        out[arch] = step_both(arch, group)
        out[arch]["seconds"] = time.perf_counter() - t0
    copy = sharding.TensorParallel.copy
    sharding.TensorParallel.copy = lambda self, x: x
    try:
        r = step_both("granite-3-8b", group)
    finally:
        sharding.TensorParallel.copy = copy
    out["planted"] = {k: v for k, v in r["grad_gaps"].items()
                      if k.endswith(("ln1", "ln2", "ln_f"))}
    every = [None] * world
    dist.all_gather_object(every, out, group=group.control)
    return every


def one_rank_main(rank, world):
    """Granite's loss and gradients on a one-rank group and on none: the
    largest elementwise difference (0.0 when bit for bit)."""
    torch.set_num_threads(1)
    group = make_serving_group((1, 1), "gloo", rank, world)
    cfg = get_config("granite-3-8b", "reduced")
    whole = from_jax_params(numpy_params(cfg))
    batch = batch_of(cfg)
    loss1, _, g1 = value_and_grad(build_model(cfg, torch.float32, "cpu"),
                                  fresh(whole), batch)
    model = build_model(cfg, torch.float32, "cpu", group=group)
    loss, _, g = value_and_grad(model, fresh(model.shard(whole)), batch)
    w = dict(named_leaves(g1))
    return {"loss": float((loss - loss1).abs()),
            "grads": max(float((x - w[n]).abs().max())
                         for n, x in named_leaves(g))}


if __name__ == "__main__":
    t0 = time.perf_counter()
    res = spawn_ranks(rank_main, MESH[0] * MESH[1], timeout_s=240)
    one = spawn_ranks(one_rank_main, 1, timeout_s=120)
    print("RESULT" + json.dumps({"ranks": res, "one_rank": one,
                                 "seconds": time.perf_counter() - t0}))
