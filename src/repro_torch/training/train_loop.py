"""The training loop, the port's twin of the JAX package's
`training/train_loop.py`: a train step (the loss and its gradients, then
AdamW), and a host loop that reads the loss once a step, logs and writes
a checkpoint at the end.

    res = train(build_model(cfg, device="cuda"), TrainConfig(steps=50))

The params are leaves that require grad; each step writes their update in
place (`optimizer.adamw_update`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.config.base import TrainConfig
from repro_torch.models.model import Model
from repro_torch.params import named_leaves
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import MarkovData
from repro_torch.training.optimizer import adamw_init, adamw_update


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def trainable(params) -> Dict[str, Any]:
    """The params as leaves that require grad (detached from any graph)."""
    return {k: trainable(v) if isinstance(v, dict)
            else v.detach().requires_grad_(v.is_floating_point())
            for k, v in params.items()}


def _unflatten(names, values) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, v in zip(names, values):
        *path, leaf = name.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def value_and_grad(model: Model, params, batch, remat: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Dict[str, Any]]:
    """(loss, {"ce", "aux"}, grads): `model.loss_fn` and its gradient with
    respect to every param leaf, as a tree shaped as the params (a leaf
    the loss does not reach gets zeros)."""
    loss, metrics = model.loss_fn(params, batch, remat=remat)
    names, leaves = zip(*named_leaves(params))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        _unflatten(names, grads)


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): one
    step, its metrics ("loss", "ce", "aux", "lr", "grad_norm") tensors on
    the device."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(model, params, batch,
                                              tcfg.remat)
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, tcfg,
                                                      model.tp)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    """A numpy batch of `MarkovData` as tensors on `device`."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train(model: Model, tcfg: TrainConfig,
          data: Optional[MarkovData] = None,
          log: Optional[Callable[[str], None]] = print,
          checkpoint_path: Optional[str] = None,
          params=None) -> Dict[str, Any]:
    """tcfg.steps steps on `data` (MarkovData from tcfg.seed by default)
    from `params` (by default `model.init(tcfg.seed)`: a seeded
    torch.Generator on the model's device). Returns "losses" (one host read
    a step), "params", "opt_state", "wall_s", "tokens_per_s" and
    "step_ms" (each step's time: CUDA events on the card, the host clock
    on the CPU)."""
    data = data or MarkovData(model.cfg, tcfg)
    params = trainable(model.init(tcfg.seed) if params is None else params)
    opt_state = adamw_init(params)
    step_fn = make_train_step(model, tcfg)
    cuda = model.device.type == "cuda"

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    losses: List[float] = []
    marks = []
    it = data.batches()
    t0 = time.perf_counter()
    for step in range(1, tcfg.steps + 1):
        batch = to_device(next(it), model.device)
        start = mark()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        marks.append((start, mark()))
        loss = float(metrics["loss"])
        losses.append(loss)
        if log and (step % tcfg.log_every == 0 or step == 1):
            log(f"step {step:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.2f}")
    wall = time.perf_counter() - t0
    # the last loss read waited for every step, so the events are done
    step_ms = [a.elapsed_time(b) if cuda else (b - a) * 1e3
               for a, b in marks]
    if checkpoint_path:
        save_checkpoint(checkpoint_path, params, opt_state, tcfg.steps)
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "wall_s": wall, "step_ms": step_ms,
            "tokens_per_s": tcfg.steps * tcfg.global_batch * tcfg.seq_len
            / wall}
