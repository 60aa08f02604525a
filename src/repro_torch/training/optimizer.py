"""AdamW with a warmup-then-cosine schedule and clipping by global norm, the
port's twin of the JAX package's `training/optimizer.py`, on the port's
nested dicts of tensors.

The moments are fp32 whatever the params' dtype, and each update is done
in fp32 and cast back to the param's dtype (the leaves of
`backbone.FP32_LEAVES` are fp32 already). The step, the learning rate, the
bias corrections and the clip factor are fp32 tensors on the params'
device, as jnp computes them, so an update reads nothing back to the
host. The update writes into the params and moments it is given and
returns them: the torch form of the reference's donated buffers
(`donate_argnums=(0, 1)`), which keeps one copy of the state on the card.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.config.base import TrainConfig
from repro_torch.params import named_leaves


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def adamw_init(params) -> Dict[str, Any]:
    """Zero fp32 moments shaped as the params, and step 0 (int32)."""
    def zeros(x):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    leaf = next(named_leaves(params))[1]
    return {"m": _map(zeros, params), "v": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def lr_schedule(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """lr x min(step / warmup, 1) x (0.1 + 0.9 x cosine decay over the
    steps after warmup), in fp32: it falls to 0.1 lr at cfg.steps."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def _slices(x: torch.Tensor):
    """A stacked matrix leaf (layers, ...) as its layers' views, else the
    leaf: the fp32 temporaries of a norm or an update then take one
    layer's bytes, not the stack's (6.9 GB a temporary for mamba2-2.7b's
    in_proj stack)."""
    return x.unbind(0) if x.dim() >= 3 else (x,)


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    return sum(torch.sum(torch.square(s.float())) for s in _slices(x))


def global_norm(tree, tp=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, the leaves
    summed in the JAX package's order. Under a tensor-parallel group
    (`tp`, a `distributed.sharding.TensorParallel`; `tree` a rank's
    shards) the squares of the cut leaves (and cut segments) are summed
    over the group and those of the leaves every rank holds whole are
    counted once, so every rank clips by the one-device norm."""
    if tp is None:
        return torch.sqrt(sum(_sumsq(x) for _, x in named_leaves(tree)))
    leaf = next(named_leaves(tree))[1]
    cut = torch.zeros((), dtype=torch.float32, device=leaf.device)
    whole = torch.zeros((), dtype=torch.float32, device=leaf.device)
    for name, x in named_leaves(tree):
        for part, is_cut in tp.norm_parts(name, x):
            if is_cut:
                cut = cut + _sumsq(part)
            else:
                whole = whole + _sumsq(part)
    return torch.sqrt(tp.group.all_reduce(cut) + whole)


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: TrainConfig, tp=None):
    """One AdamW step of every leaf, the reference's arithmetic op for op:

        g = g * min(1, clip / (|grads| + 1e-9))
        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
        p = p - lr (m / bc1 / (sqrt(v / bc2) + 1e-8) + wd p)

    with bc_i = 1 - b_i^step, a stacked leaf one layer at a time. Params
    and moments are written in place; under a group (`tp`) they are the
    rank's shards, clipped by the global norm over the group
    (`global_norm`). Returns (params, {"m", "v", "step"}, {"lr",
    "grad_norm"})."""
    step = opt_state["step"] + 1
    lr = lr_schedule(step, cfg)
    gn = global_norm(grads, tp)
    clip = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0) \
        if cfg.grad_clip else 1.0
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    leaves = zip(named_leaves(params), named_leaves(grads),
                 named_leaves(opt_state["m"]), named_leaves(opt_state["v"]))
    for (_, p), (_, g), (_, m), (_, v) in leaves:
        for p, g, m, v in zip(*map(_slices, (p, g, m, v))):
            g = g.float() * clip
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_(((1 - b2) * g).mul_(g))
            del g
            den = torch.sqrt(v / bc2).add_(1e-8)
            delta = (m / bc1).div_(den).add_(cfg.weight_decay * p.float())
            del den
            p.copy_(p.float().sub_(delta.mul_(lr)))
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, {"lr": lr, "grad_norm": gn}
