"""Rank processes of tests/test_torch_tp_layouts.py.

    PYTHONPATH=src:tests python tests/_torch_tp_layouts_ranks.py

One spawn of 8 gloo ranks (`launch.mesh.spawn_ranks`) serves the layouts
`sharding.check_tp` once refused, each on the first ranks of the world
(`launch.mesh.mesh_group`), and prints one line `RESULT<json>` of rank
0's records:

* split query heads and cross K/V under the head_dim fallback
  (`LAYOUTS`): reduced configs given head counts the model axis of 4
  does not divide, served by the port's engine in both cache layouts on
  (1, 4) and (2, 4) meshes (tokens, counters, whether every rank agreed
  step for step), a first chunk's and a decode step's all-reduces and
  gathers traced, and on (1, 4) one training step's gradient gaps
  against one device's (the rank's slices);
* the sequence-sharded decode (`SEQ`): each rank fills a whole cache
  token by token, keeps its data rank's slots (`cache_specs(seq_shard=
  True)`) and takes `N_DECODE` steps through `Model.decode_step(
  seq_shard=True)` on (2, 1), (4, 1) and (2, 2) meshes; the logits of
  those steps, and the gathers a step traces.

The weights are `_torch_tp_ranks.numpy_params(cfg)`, which the test hands
to the JAX package too.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

import _torch_tp_ranks as R
from _torch_tp_train_ranks import batch_of, fresh, gaps
from repro_torch.analysis.graph_audit import GATHER, OpTrace
from repro_torch.config.base import AttentionKind
from repro_torch.config.registry import get_config
from repro_torch.launch.mesh import make_serving_group, mesh_group, spawn_ranks
from repro_torch.models.model import build_model
from repro_torch.params import from_jax_params
from repro_torch.training.train_loop import value_and_grad

WORLD = 8
#: the split-head and cross-fallback configs, by name (`layout_config`)
LAYOUTS = ("heads-6-on-2", "heads-12-on-3", "llama-3.2-vision-90b",
           "seamless-heads-6-on-2")
LAYOUT_MESHES = ((1, 4), (2, 4))
#: the sequence-sharded decode's configs and meshes
SEQ = ("granite-3-8b", "mistral-nemo-sliding", "recurrentgemma-9b")
SEQ_MESHES = ((2, 1), (4, 1), (2, 2))
#: prompt tokens filled one by one, then the decode steps compared
N_PROMPT, N_DECODE, SEQ_CONTEXT = 70, 6, 96


def layout_config(name: str, get=get_config):
    """The reduced config of `name` from `get` (this package's or the JAX
    package's `get_config`). "heads-6-on-2": granite with 6 query heads on
    2 kv-heads at head_dim 16 (1.5 heads a rank at m = 4, the kv-heads on
    the head_dim fallback); "heads-12-on-3": 12 on 3 (3 a rank, whose
    heads read parts of two kv-heads); "seamless-heads-6-on-2": the
    enc-dec family so, its encoder, self and cross layers all split;
    reduced llama-3.2-vision (2 kv-heads: its cross K/V on the
    fallback)."""
    if name == "heads-6-on-2":
        return dataclasses.replace(get("granite-3-8b", "reduced"), name=name,
                                   num_heads=6, num_kv_heads=2, head_dim=16)
    if name == "heads-12-on-3":
        return dataclasses.replace(get("granite-3-8b", "reduced"), name=name,
                                   num_heads=12, num_kv_heads=3, head_dim=16)
    if name == "seamless-heads-6-on-2":
        return dataclasses.replace(get("seamless-m4t-medium", "reduced"),
                                   name=name, num_heads=6, num_kv_heads=2,
                                   head_dim=16)
    return get(name, "reduced")


def seq_config(name: str, get=get_config):
    """The reduced config of `name`; "mistral-nemo-sliding": reduced
    mistral-nemo on a 16-token sliding window (its ring wraps)."""
    if name == "mistral-nemo-sliding":
        cfg = get("mistral-nemo-12b", "reduced")
        kind = type(cfg.attention)
        return dataclasses.replace(cfg, name=name,
                                   attention=kind(AttentionKind.SLIDING.value),
                                   sliding_window=16)
    return get(name, "reduced")


def seq_tokens(cfg) -> np.ndarray:
    rng = np.random.RandomState(11)
    return rng.randint(0, cfg.vocab_size, size=N_PROMPT + N_DECODE)


def layouts(group, mesh) -> dict:
    out = {}
    for name in LAYOUTS:
        cfg = layout_config(name)
        model = build_model(cfg, torch.float32, "cpu", group=group)
        params = model.shard(from_jax_params(R.numpy_params(cfg)))
        for paged in (True, False):
            out[f"{name} {'paged' if paged else 'contiguous'}"] = \
                R.run_engine(model, params, group,
                             R.serve_cfg(mesh, paged=paged), R.FAM_LENS, 8,
                             seed=R.FAM_SEED)
        out[f"{name} collectives"] = R.forward_allreduces(model, params)
        out[f"{name} q_gather"] = model.tp.q_gather
    return out


def training(group) -> dict:
    """One training step of each `LAYOUTS` config: the rank's loss beside
    one device's, and its gradients' gaps from its slices of the one
    device's (`_torch_tp_train_ranks.gaps`)."""
    out = {}
    for name in LAYOUTS:
        cfg = layout_config(name)
        whole = from_jax_params(R.numpy_params(cfg))
        batch = batch_of(cfg)
        loss1, _, g1 = value_and_grad(build_model(cfg, torch.float32, "cpu"),
                                      fresh(whole), batch)
        model = build_model(cfg, torch.float32, "cpu", group=group)
        loss, _, g = value_and_grad(model, fresh(model.shard(whole)), batch)
        out[name] = dict(loss=float(loss), loss_one=float(loss1),
                         grad_gaps=gaps(g, model.shard(g1)))
    return out


def seq_decode(group) -> dict:
    """Each `SEQ` config: the whole cache filled token by token, this data
    rank's slots kept, then `N_DECODE` sequence-sharded steps; their
    logits and one step's gathers."""
    out = {}
    D, d = group.data_size, group.data_rank
    for name in SEQ:
        cfg = seq_config(name)
        model = build_model(cfg, torch.float32, "cpu", group=group)
        params = model.shard(from_jax_params(R.numpy_params(cfg)))
        toks = torch.from_numpy(seq_tokens(cfg))
        cache = model.init_cache(1, SEQ_CONTEXT)
        for t in range(N_PROMPT):
            model.decode_step(params, toks[t:t + 1],
                              torch.tensor([t], dtype=torch.int32), cache)
        S = cache["pos"].shape[1] // D
        mine = slice(d * S, (d + 1) * S)
        cache = {k: v[:, :, mine].clone() if k in ("k", "v")
                 else v[:, mine].clone() if k == "pos" else v
                 for k, v in cache.items()}
        logits, gathered = [], []
        for t in range(N_PROMPT, N_PROMPT + N_DECODE):
            with OpTrace() as tr:
                lg, _ = model.decode_step(
                    params, toks[t:t + 1], torch.tensor([t], dtype=torch.int32),
                    cache, seq_shard=True)
            logits.append(lg[0].numpy())
            gathered.append(tr.collectives[GATHER])
        out[name] = {"logits": np.stack(logits), "gathers": gathered,
                     "slots": S}
    return out


def rank_main(rank, world):
    torch.set_num_threads(1)
    groups = {(2, 4): make_serving_group((2, 4), "gloo", rank, world)}
    groups.update((mesh, mesh_group(mesh, "gloo", rank))
                  for mesh in ((1, 4),) + SEQ_MESHES)
    out = {}
    for mesh in LAYOUT_MESHES:
        group = groups[mesh]
        if group is None:
            continue
        t0 = time.perf_counter()
        out[",".join(map(str, mesh))] = layouts(group, mesh)
        if mesh == (1, 4):
            out["train"] = training(group)
        out[f"seconds {mesh}"] = time.perf_counter() - t0
    for mesh in SEQ_MESHES:
        group = groups[mesh]
        if group is not None:
            out["seq " + ",".join(map(str, mesh))] = seq_decode(group)
    return out


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


if __name__ == "__main__":
    t0 = time.perf_counter()
    res = spawn_ranks(rank_main, WORLD, timeout_s=400)
    res["seconds"] = time.perf_counter() - t0
    print("RESULT" + json.dumps(_plain(res)))
