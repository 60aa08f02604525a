"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
package's.

* The FSDP x TP specs (`distributed.sharding.param_specs`, `cache_specs`,
  `batch_specs`, `decode_input_specs`) equal the JAX package's
  `param_shardings`, `cache_shardings`, `batch_shardings` and
  `decode_input_shardings` leaf for leaf, for every arch at full size, on
  abstract meshes (no devices): the production (16, 16) and (2, 16, 16),
  the latter with REPRO_POD_MODE unset and "dp" (the port's `pod_mode`),
  and (4, 2), (1, 8), (1, 1); the JAX `init_shapes()` equal the port's
  meta init leaf for leaf.
* A rank's argument bytes by those specs (`dryrun.argument_bytes`) equal
  XLA's own `memory_analysis().argument_size_in_bytes` of the JAX step
  compiled on a (4, 2) mesh of 8 CPU devices in a subprocess (the
  pattern of tests/test_sharding.py), byte for byte: the train step of
  the six families and the decode step (cache shardings explicit, the
  cache donated) of granite, qwen2-moe and recurrentgemma. mamba2's
  decode step reads no position, and XLA drops its unused `seq_lens`:
  the port counts 4 bytes more, that leaf's.
* The meta step is faithful: its FLOP count equals FlopCounterMode's of
  the same reduced train step run on the CPU, integer for integer; a
  decode forward on a (1, 2) recording group makes the all-reduces and
  all-gathers `graph_audit` gives the layout, and a batch-1 decode on a
  (4, 2) one the sequence-sharded decode's (one more gather a
  self-attention layer, over the data axis).
* The CLI writes a row, skips it on a second run, and its skipped rows
  carry their reasons; starcoder2-7b's split heads and mamba2's long_500k
  on a data axis are reckoned, and a layout `check_tp` still refuses is a
  refused row in its words.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.config.base import INPUT_SHAPES as J_SHAPES
from repro.config.registry import get_config as jax_config
from repro.distributed.sharding import (_path_str, batch_shardings,
                                        cache_shardings,
                                        decode_input_shardings,
                                        param_shardings)
from repro.models.model import Model as JModel
from repro.models.model import input_specs as jax_input_specs

from repro_torch.analysis import meta_step
from repro_torch.analysis.graph_audit import allreduces, gathers
from repro_torch.config.base import INPUT_SHAPES, InputShape, TrainConfig
from repro_torch.config.registry import get_config, list_archs
from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                              decode_input_specs,
                                              param_specs)
from repro_torch.launch import dryrun
from repro_torch.models.backbone import init_params, phys_cache_len
from repro_torch.models.model import build_model, input_specs
from repro_torch.params import named_leaves
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import make_train_step, trainable

SRC = str(Path(__file__).resolve().parent.parent / "src")
#: (axis sizes, axis names) of the meshes the specs are held on
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((1, 8), ("data", "model")),
          ((1, 1), ("data", "model"))]
FAMILIES = ("granite-3-8b", "mamba2-2.7b", "recurrentgemma-9b",
            "qwen2-moe-a2.7b", "llama-3.2-vision-90b", "seamless-m4t-medium")


def _flat(tree):
    """{path: leaf} of a JAX pytree of shardings or shapes."""
    return {_path_str(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _sizes(shape, names):
    return dict(zip(names, shape))


@pytest.mark.parametrize("pod_mode", ["fsdp", "dp"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_the_jax_package(arch, pod_mode, monkeypatch):
    if pod_mode == "dp":
        monkeypatch.setenv("REPRO_POD_MODE", "dp")
    else:
        monkeypatch.delenv("REPRO_POD_MODE", raising=False)
    cfg, jcfg = get_config(arch), jax_config(arch)
    theirs = _flat(JModel(jcfg, dtype=jnp.bfloat16).init_shapes())
    ours = dict(named_leaves(init_params(cfg, device="meta")))
    assert {n: tuple(t.shape) for n, t in ours.items()} \
        == {n: tuple(s.shape) for n, s in theirs.items()}
    for shape, names in MESHES:
        if pod_mode == "dp" and "pod" not in names:
            continue
        jspecs = _flat(param_shardings(
            JModel(jcfg, dtype=jnp.bfloat16).init_shapes(), jcfg,
            AbstractMesh(shape, names)))
        specs = dict(named_leaves(param_specs(
            init_params(cfg, device="meta"), cfg, _sizes(shape, names),
            pod_mode)))
        assert specs == {n: tuple(s.spec) for n, s in jspecs.items()}, \
            (shape, names)


@pytest.mark.parametrize("arch", list_archs())
def test_cache_batch_and_decode_input_specs_equal_the_jax_package(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    cases = [("decode_32k", cfg, jcfg, False)]
    if arch in dryrun.LONG_OK:
        shape = INPUT_SHAPES["long_500k"]
        c = dryrun.resolve_config(arch, shape)
        if arch == "mistral-nemo-12b":
            from repro.configs.mistral_nemo_12b import sliding
            jc = sliding(4096)
        else:
            jc = jcfg
        cases.append(("long_500k", c, jc, True))
    for shape, names in MESHES:
        mesh, sizes = AbstractMesh(shape, names), _sizes(shape, names)
        for name, c, jc, seq in cases:
            jspec = jax_input_specs(jc, J_SHAPES[name], dtype=jnp.bfloat16)
            spec = input_specs(c, INPUT_SHAPES[name], torch.bfloat16)
            assert {n: tuple(t.shape) for n, t in spec["cache"].items()} \
                == {n: tuple(s.shape) for n, s in jspec["cache"].items()}
            theirs = _flat(cache_shardings(jspec["cache"], jc, mesh,
                                           seq_shard=seq))
            assert cache_specs(spec["cache"], sizes, seq_shard=seq) \
                == {n: tuple(s.spec) for n, s in theirs.items()}, \
                (name, shape)
            B = INPUT_SHAPES[name].global_batch
            assert decode_input_specs(sizes, B) == tuple(
                decode_input_shardings(jc, mesh, B).spec)
        for name in ("train_4k", "prefill_32k"):
            jspec = jax_input_specs(jcfg, J_SHAPES[name], dtype=jnp.bfloat16)
            jspec.pop("cache", None)
            spec = input_specs(cfg, INPUT_SHAPES[name], torch.bfloat16)
            spec.pop("cache", None)
            theirs = _flat(batch_shardings(jspec, jcfg, mesh))
            ours = dict(named_leaves(batch_specs(spec, sizes)))
            assert ours == {n: tuple(s.spec) for n, s in theirs.items()}, \
                (name, shape)


XLA_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax, jax.numpy as jnp
    from repro.config.registry import get_config
    from repro.config.base import TrainConfig, InputShape
    from repro.distributed.sharding import (param_shardings,
        batch_shardings, cache_shardings, decode_input_shardings,
        replicated)
    from repro.launch.mesh import make_test_mesh
    from repro.models.model import Model, input_specs
    from repro.training.optimizer import adamw_init
    from repro.training.train_loop import make_train_step

    mesh = make_test_mesh((4, 2))
    out = {}
    for arch in %r:
        cfg = get_config(arch, "reduced")
        model = Model(cfg, dtype=jnp.float32)
        pshapes = model.init_shapes()
        pshard = param_shardings(pshapes, cfg, mesh)
        specs = input_specs(cfg, InputShape("t", 16, 4, "train"),
                            dtype=jnp.float32)
        oshapes = jax.eval_shape(adamw_init, pshapes)
        osh = {"m": pshard, "v": pshard, "step": replicated(mesh)}
        fn = make_train_step(model, TrainConfig(global_batch=4, seq_len=16))
        with jax.set_mesh(mesh):
            c = jax.jit(fn, in_shardings=(pshard, osh, batch_shardings(
                specs, cfg, mesh))).lower(pshapes, oshapes, specs).compile()
        out[arch] = {"train": c.memory_analysis().argument_size_in_bytes}
        if arch not in %r:
            continue
        d = input_specs(cfg, InputShape("d", 64, 4, "decode"),
                        dtype=jnp.float32)
        tok = decode_input_shardings(cfg, mesh, 4)

        def serve_step(params, tokens, seq_lens, cache):
            lg, cache = model.decode_step(params, tokens, seq_lens, cache)
            return jnp.argmax(lg, -1).astype(jnp.int32), cache

        with jax.set_mesh(mesh):
            c = jax.jit(serve_step, in_shardings=(
                pshard, tok, tok, cache_shardings(d["cache"], cfg, mesh)),
                donate_argnums=(3,)).lower(
                pshapes, d["tokens"], d["seq_lens"], d["cache"]).compile()
        out[arch]["decode"] = c.memory_analysis().argument_size_in_bytes
    print("RESULT" + json.dumps(out))
""")
DECODE = ("granite-3-8b", "qwen2-moe-a2.7b", "recurrentgemma-9b",
          "mamba2-2.7b")


@pytest.fixture(scope="module")
def xla_bytes():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c",
                           XLA_SCRIPT % (FAMILIES, DECODE)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT")][0]
    return json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("arch", FAMILIES)
def test_argument_bytes_equal_xla_memory_analysis(xla_bytes, arch):
    cfg = get_config(arch, "reduced")
    sizes = {"data": 4, "model": 2}
    train = dryrun.argument_bytes(cfg, InputShape("t", 16, 4, "train"),
                                  sizes, dtype=torch.float32)
    assert sum(train.values()) == xla_bytes[arch]["train"]
    if arch not in DECODE:
        return
    decode = dryrun.argument_bytes(cfg, InputShape("d", 64, 4, "decode"),
                                   sizes, dtype=torch.float32)
    gap = sum(decode.values()) - xla_bytes[arch]["decode"]
    if arch == "mamba2-2.7b":
        # mamba2 reads no position: XLA drops the unused seq_lens, one
        # int32 a rank (B 4 over data 4)
        assert gap == decode["seq_lens"] == 4
    else:
        assert gap == 0


def _cpu_train_step(cfg, shape):
    model = build_model(cfg, torch.float32, "cpu")
    params = trainable(model.init(0))
    opt = adamw_init(params)
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in input_specs(cfg, shape, torch.float32).items()}
    step = make_train_step(model, TrainConfig(
        global_batch=shape.global_batch, seq_len=shape.seq_len, remat=True))
    return lambda: step(params, opt, batch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_flops_equal_a_cpu_run(arch):
    cfg = get_config(arch, "reduced")
    shape = InputShape("t", 16, 2, "train")
    row = dryrun.run_one(cfg, shape, {"data": 1, "model": 1},
                         dtype=torch.float32)
    assert row["status"] == "ok"
    cpu = meta_step.run(_cpu_train_step(cfg, shape))["flops"]
    assert row["flops"] == cpu > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_recorded_decode_collectives_are_the_layouts(arch):
    cfg = get_config(arch, "reduced")
    group = meta_step.RecordingGroup((1, 2))
    model = build_model(cfg, torch.float32, "meta", group=group)
    params = model.init(0)
    cache = model.init_cache(2, 32)
    tokens = torch.zeros(2, dtype=torch.int64, device="meta")
    res = meta_step.run(lambda: model.decode_step(
        params, tokens, tokens.int(), cache), group)
    assert group.calls["all-reduce"] == allreduces(model.local_cfg,
                                                   model.tp) > 0
    assert group.calls["all-gather"] == gathers(model.local_cfg, model.tp)
    assert res["collectives"]["count"] == sum(group.calls.values())


@pytest.mark.parametrize("arch", ["granite-3-8b", "recurrentgemma-9b",
                                  "mamba2-2.7b"])
def test_recorded_seq_decode_collectives_are_the_layouts(arch):
    """A batch-1 decode on a (4, 2) mesh cuts the cache's slots over
    "data" (`dryrun.seq_sharded`): each rank holds S/4 of them, and the
    step's all-gathers are the layout's plus one a self-attention layer
    over the data axis (`gathers(seq=True)`); mamba2, with no K/V, steps
    its whole state."""
    cfg = get_config(arch, "reduced")
    sizes = {"data": 4, "model": 2}
    shape = InputShape("long", 64, 1, "decode")
    seq = dryrun.seq_sharded(cfg, shape, sizes)
    assert seq == (arch != "mamba2-2.7b")
    group = meta_step.RecordingGroup((4, 2))
    model = build_model(cfg, torch.float32, "meta", group=group)
    params = model.init(0)
    cache = model.init_cache(1, 64, seq_shard=seq)
    if seq:
        assert cache["k"].shape[2] * 4 == phys_cache_len(cfg, 64)
    tokens = torch.zeros(1, dtype=torch.int64, device="meta")
    meta_step.run(lambda: model.decode_step(params, tokens, tokens.int(),
                                            cache, seq_shard=seq), group)
    assert group.calls["all-reduce"] == allreduces(model.local_cfg,
                                                   model.tp)
    assert group.calls["all-gather"] == gathers(model.local_cfg, model.tp,
                                                seq=seq)
    row = dryrun.run_one(cfg, shape, sizes, dtype=torch.float32)
    assert row["status"] == "ok" and row["flops"] > 0


def test_cli_writes_skips_and_gives_reasons(tmp_path, capsys):
    out = str(tmp_path / "dry.jsonl")
    argv = ["--arch", "granite-3-8b", "--shape", "train_4k", "--mesh",
            "single", "--out", out]
    dryrun.main(argv)
    dryrun.main(argv)
    assert "skip (cached): granite-3-8b train_4k 16x16" in capsys.readouterr(
    ).out
    dryrun.main(["--arch", "granite-3-8b", "--shape", "long_500k",
                 "--mesh", "card", "--out", out])
    dryrun.main(["--arch", "starcoder2-7b", "--shape", "decode_32k",
                 "--mesh", "single", "--out", out])
    dryrun.main(["--arch", "mamba2-2.7b", "--shape", "long_500k",
                 "--mesh", "single", "--out", out])
    rows = [json.loads(ln) for ln in open(out)]
    assert [r["status"] for r in rows] == ["ok", "skipped", "ok", "ok"]
    ok = rows[0]
    assert ok["mesh"] == "16x16" and ok["fits"] is True
    assert ok["peak_bytes"] == ok["argument_size_in_bytes"] \
        + ok["gathered_bytes"] + ok["temp_size_in_bytes"]
    assert ok["collectives"]["all-reduce"] > 0 and ok["flops"] > 0
    assert "sub-quadratic" in rows[1]["reason"]
    # starcoder2's 36 query heads split over 16 (q gathered, K/V on
    # head_dim), and mamba2's batch-1 step on every data rank
    split = rows[2]
    assert split["argument_size_in_bytes"] > 0 and split["flops"] > 0
    assert split["collectives"]["all-gather"] > 0
    assert rows[3]["flops"] > 0
    # a layout `check_tp` still refuses is a refused row, in its words
    cfg = get_config("granite-3-8b", "reduced")
    row = dryrun.run_one(cfg, INPUT_SHAPES["decode_32k"],
                         {"data": 1, "model": 3})
    assert row["status"] == "refused" and row["argument_size_in_bytes"] > 0
    assert "neither its 2 kv-heads nor head_dim 32" in row["reason"]
