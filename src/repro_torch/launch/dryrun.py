"""The port's dry run: every (arch x input shape x mesh), one rank's step on
the meta device, the twin of the JAX package's `launch/dryrun.py`.

    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape train_4k --mesh card

Where the JAX package lowers and compiles each step for a TPU pod of
16 x 16 (or two) by GSPMD, the port runs the step of one rank on the
meta device (`analysis.meta_step`), for those meshes and for H100 ones
(`--mesh card`: one card, `--mesh node`: a model axis of 8, one NVLink
node). A row (one JSON line, appended to --out; a second run skips the
rows already written) holds:

* status: ok, skipped (long_500k of an arch with quadratic attention, the
  JAX reason), refused (a layout the port does not run: `check_tp`'s
  words) or error. A batch-1 decode on a data axis (long_500k) runs the
  sequence-sharded decode (`Model.decode_step(seq_shard=True)` over the
  rank's S/data slots, its partial results gathered over the data axis),
  as the JAX dry run shards the cache (`cache_specs(seq_shard=True)`);
  mamba2, which has no K/V, steps its whole state on every data rank;
* argument_size_in_bytes: a rank's arguments by the JAX dry run's layout
  (`param_specs` FSDP x TP for every shape, the AdamW moments and step
  of a train step, `batch_specs`, explicit `cache_specs`,
  `decode_input_specs`), with its parts in `arguments`: what XLA's
  `memory_analysis` reports, reckoned on refused rows too;
* temp_size_in_bytes: the meta step's peak above its own arguments
  (`meta_step.PeakMemory`). The step is the port's: the rank's
  tensor-parallel shard of the params (whole over the data axes; the
  port runs no FSDP trainer) at the local batch B/data, remat on;
* gathered_bytes: the params' TP shard less their FSDP shard, which the
  rank gathers (`fsdp_collectives`); peak_bytes = arguments + gathered +
  temp (no temp on a refused row), and fits: peak_bytes within
  `CAPACITY_BYTES` of `CAPACITY_OF`.
  Where data > 1 the step's temps hold the whole TP shard's gradients,
  which an FSDP step reduce-scatters as they come: the peak is then an
  upper bound;
* flops: FlopCounterMode's count of the step's products plus the
  kernels' meta FLOPs (`kernels.meta`);
* collectives: a rank's bytes a step under the JAX keys, and their
  count: the tensor-parallel ones as the step makes them (a
  `RecordingGroup`), the FSDP ones by `fsdp_collectives`;
* serve_weight_bytes: what a serving rank of the port holds (its
  `serve_spec` shard; mamba2's by segment);
* params, active_params, meta_s (the step's seconds on the meta device,
  in place of the JAX lower_s / compile_s).

`run_one(cfg, shape, mesh)` is the entry for a config and shape of the
caller's (chip_smoke.py's cut ones).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Mapping, Optional

import torch

from repro_torch.analysis import meta_step
from repro_torch.config.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                     TrainConfig)
from repro_torch.config.registry import get_config, list_archs
from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                              data_axes, decode_input_specs,
                                              local_bytes, param_specs,
                                              serve_spec)
from repro_torch.launch.mesh import (CARD_MESHES, make_production_mesh,
                                     mesh_name)
from repro_torch.models import backbone as B
from repro_torch.models.model import Model, input_specs
from repro_torch.params import named_leaves
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import make_train_step, trainable

#: long_500k applicability (DESIGN §4): sub-quadratic state only
LONG_OK = {
    "mamba2-2.7b": "constant SSM state",
    "recurrentgemma-9b": "RG-LRU + 2048-window ring cache",
    "mistral-nemo-12b": "sliding-window variant (window 4096)",
}
SKIPPED = "long_500k requires sub-quadratic attention (DESIGN §4)"

#: the device memory a rank's peak is held against
CAPACITY_BYTES = 80 * 10 ** 9
CAPACITY_OF = "NVIDIA H100 80GB HBM3"

MESHES = {"single": [make_production_mesh()],
          "multi": [make_production_mesh(multi_pod=True)],
          "both": [make_production_mesh(),
                   make_production_mesh(multi_pod=True)],
          "card": [CARD_MESHES["card"]], "node": [CARD_MESHES["node"]]}


def resolve_config(arch: str, shape: InputShape) -> Optional[ModelConfig]:
    """The config the dry run takes for (arch, shape): None where
    long_500k does not apply; mistral-nemo's sliding variant at
    long_500k; the MoE's serving rows with capacity-factor dispatch."""
    if shape.name == "long_500k":
        if arch not in LONG_OK:
            return None
        if arch == "mistral-nemo-12b":
            from repro_torch.configs.mistral_nemo_12b import sliding
            return sliding(4096)
    cfg = get_config(arch)
    if cfg.moe is not None and shape.kind != "train":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, inference_no_drop=False, capacity_factor=2.0))
    return cfg


def _bytes(tree, specs, sizes) -> int:
    s = dict(named_leaves(specs))
    return sum(local_bytes(t, s[n], sizes) for n, t in named_leaves(tree))


def argument_bytes(cfg: ModelConfig, shape: InputShape,
                   sizes: Mapping[str, int], pod_mode: str = "fsdp",
                   dtype: Optional[torch.dtype] = None) -> Dict[str, int]:
    """A rank's arguments by the JAX dry run's layout, by part: params
    (FSDP x TP), a train step's fp32 moments and int32 step, and the
    inputs (a decode step's cache with `seq_shard` at batch 1)."""
    dt = B.cfg_dtype(cfg, dtype)
    params = B.init_params(cfg, dtype=dt, device="meta")
    pspecs = param_specs(params, cfg, sizes, pod_mode)
    out = {"params": _bytes(params, pspecs, sizes)}
    specs = input_specs(cfg, shape, dt)
    if shape.kind == "train":
        moments = {n: torch.empty(t.shape, dtype=torch.float32,
                                  device="meta")
                   for n, t in named_leaves(params)}
        ms = dict(named_leaves(pspecs))
        out["m"] = out["v"] = sum(local_bytes(t, ms[n], sizes)
                                  for n, t in moments.items())
        out["step"] = 4
        for name, t in specs.items():
            out[name] = _bytes({name: t}, batch_specs({name: t}, sizes),
                               sizes)
        return out
    cache = specs.pop("cache")
    out["cache"] = _bytes(cache, cache_specs(
        cache, sizes, seq_shard=shape.global_batch == 1), sizes)
    if shape.kind == "decode":
        spec = decode_input_specs(sizes, shape.global_batch)
        for name, t in specs.items():
            out[name] = local_bytes(t, spec, sizes)
        return out
    for name, t in specs.items():
        out[name] = _bytes({name: t}, batch_specs({name: t}, sizes), sizes)
    return out


def fsdp_collectives(cfg: ModelConfig, sizes: Mapping[str, int],
                     train: bool, pod_mode: str = "fsdp",
                     dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, int]:
    """A rank's FSDP collectives a step, by the layout rule (the port runs
    no FSDP trainer): every param leaf cut over data axes is gathered
    over them once a step (output: its TP shard), and in a train step
    its gradient reduce-scattered back (output: its FSDP x TP shard);
    a leaf replicated over data axes has its gradient all-reduced over
    them. Also "gathered_bytes": the TP shards less the FSDP shards."""
    out = meta_step.no_collectives()
    out["gathered_bytes"] = 0
    params = B.init_params(cfg, dtype=B.cfg_dtype(cfg, dtype),
                           device="meta")
    specs = dict(named_leaves(param_specs(params, cfg, sizes, pod_mode)))
    data = data_axes(sizes)
    for name, t in named_leaves(params):
        spec = specs[name]
        on = {a for ax in spec if ax is not None
              for a in (ax if isinstance(ax, tuple) else (ax,))
              if sizes[a] > 1}
        mine = local_bytes(t, spec, sizes)
        tp = local_bytes(t, serve_spec(name, tuple(t.shape), cfg,
                                       sizes["model"]), sizes)
        if on & set(data):
            out["all-gather"] += tp
            out["gathered_bytes"] += tp - mine
            out["count"] += 1
            if train:
                out["reduce-scatter"] += mine
                out["count"] += 1
        if train and math.prod(sizes[a] for a in data if a not in on) > 1:
            out["all-reduce"] += mine
            out["count"] += 1
    return out


def seq_sharded(cfg: ModelConfig, shape: InputShape,
                sizes: Mapping[str, int]) -> bool:
    """Whether the row's decode cuts its cache's slots over "data": a
    batch-1 decode of an arch with attention layers on a data axis."""
    return shape.kind == "decode" and shape.global_batch == 1 \
        and sizes.get("data", 1) > 1 and bool(B.layer_counts(cfg)[0])


def _meta_step(cfg, shape: InputShape, sizes, dt):
    """(the step on meta tensors, its model's group, the rank's params)
    at the local batch; raises NotImplementedError where the port does
    not run the layout (`check_tp`)."""
    m = sizes["model"]
    data = math.prod(sizes[a] for a in data_axes(sizes))
    seq = seq_sharded(cfg, shape, sizes)
    group = meta_step.RecordingGroup(tuple(sizes.values())) \
        if m > 1 or seq else None
    model = Model(cfg, dt, "meta", group=group)
    params = model.init(0)
    b = shape.global_batch
    b = b // data if b % data == 0 else b
    local = dataclasses.replace(shape, global_batch=b)
    specs = input_specs(cfg, local, dt)
    T = shape.seq_len
    if shape.kind == "train":
        params = trainable(params)
        opt = adamw_init(params)
        step = make_train_step(model, TrainConfig(global_batch=b, seq_len=T,
                                                  remat=True))
        return (lambda: step(params, opt, specs)), group, params
    if shape.kind == "prefill":
        cache = model.init_cache(b, T, prefill_chunk=T)
        return (lambda: model.prefill(
            params, specs["tokens"], specs["positions"], cache,
            extras=specs.get("extras"), last_only=True)), group, params
    cache = model.init_cache(b, T, seq_shard=seq)
    return (lambda: model.decode_step(params, specs["tokens"],
                                      specs["seq_lens"], cache,
                                      seq_shard=seq)[0]
            .argmax(-1)), group, params


def run_one(cfg: ModelConfig, shape: InputShape, mesh: Mapping[str, int],
            *, pod_mode: str = "fsdp", dtype: Optional[torch.dtype] = None,
            arch: Optional[str] = None) -> Dict[str, Any]:
    """The dry-run row of `cfg` at `shape` on `mesh` ({axis: size}, the
    last axis "model")."""
    sizes = dict(mesh)
    dt = B.cfg_dtype(cfg, dtype)
    rec: Dict[str, Any] = {"arch": arch or cfg.name, "shape": shape.name,
                           "mesh": mesh_name(sizes), "status": "ok",
                           "params": cfg.param_count(),
                           "active_params": cfg.active_param_count()}
    args = argument_bytes(cfg, shape, sizes, pod_mode, dt)
    fsdp = fsdp_collectives(cfg, sizes, shape.kind == "train", pod_mode, dt)
    gathered = fsdp.pop("gathered_bytes")
    rec.update(argument_size_in_bytes=sum(args.values()), arguments=args,
               gathered_bytes=gathered, capacity_bytes=CAPACITY_BYTES,
               capacity_of=CAPACITY_OF)
    temp = None
    try:
        step, group, params = _meta_step(cfg, shape, sizes, dt)
    except NotImplementedError as e:
        rec.update(status="refused", reason=str(e), collectives=fsdp)
    else:
        rec["serve_weight_bytes"] = sum(t.numel() * t.element_size()
                                        for _, t in named_leaves(params))
        try:
            res = meta_step.run(step, group)
        except Exception:
            rec.update(status="error", error=traceback.format_exc()[-2000:])
        else:
            temp = res["temp_bytes"]
            rec.update(temp_size_in_bytes=temp, flops=res["flops"],
                       meta_s=res["meta_s"],
                       collectives={k: res["collectives"][k] + fsdp[k]
                                    for k in fsdp})
    rec["peak_bytes"] = rec["argument_size_in_bytes"] + gathered \
        + (temp or 0)
    rec["fits"] = rec["peak_bytes"] <= CAPACITY_BYTES
    return rec


def row(arch: str, shape_name: str, mesh: Mapping[str, int]
        ) -> Dict[str, Any]:
    """The row of a registry arch at a named input shape."""
    shape = INPUT_SHAPES[shape_name]
    cfg = resolve_config(arch, shape)
    if cfg is None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
                "status": "skipped", "reason": SKIPPED}
    return run_one(cfg, shape, mesh, arch=arch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=list(MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("ok", "skipped", "refused"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    t0 = time.perf_counter()
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mesh in MESHES[args.mesh]:
                    name = mesh_name(mesh)
                    if (arch, shape, name) in done:
                        print(f"skip (cached): {arch} {shape} {name}")
                        continue
                    print(f"=== {arch} x {shape} x {name}", flush=True)
                    rec = row(arch, shape, mesh)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    msg = rec["status"]
                    if rec["status"] == "ok":
                        msg += (f" meta={rec['meta_s']:.2f}s"
                                f" peak={rec['peak_bytes'] / 1e9:.2f}GB"
                                f" fits={rec['fits']}"
                                f" flops={rec['flops']:.3g}"
                                f" coll={rec['collectives']}")
                    elif rec["status"] == "error":
                        msg += "\n" + rec["error"][-500:]
                    else:
                        msg += f": {rec['reason']}"
                    print(msg, flush=True)
    print(f"dry run: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
