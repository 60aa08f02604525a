"""Tensor-parallel serving of the port (DESIGN §12), mirroring
tests/test_tp_serving.py.

A subprocess (`tests/_torch_tp_ranks.py`) runs the port's engine in rank
processes over gloo (`launch.mesh.spawn_ranks`, one thread a rank): 2
ranks on a (1, 2) mesh, then 4 on a (2, 2) mesh, reduced granite-3-8b in
fp32 on weights drawn with numpy. Meanwhile the JAX package's
single-device engine serves the same requests on the same weights in this
process. The assertions follow the JAX file's:

* tokens equal to the JAX engine's, on every rank, in both layouts;
* capacity: `model_shards` 2, the pool at twice the per-chip tokens, the
  rank's K/V at half the kv-heads, no row copy in the paged layout;
* a per-chip pool of 80 with swap behaves counter for counter like the
  JAX engine on one device at 160;
* (2, 2) parity with the port's simulator, swap off and on;

and the port's own: the `sla` policy with rank 1's clock skewed decides
alike on both ranks (the engine agrees rank 0's measured values), the
CLI's --mesh path at overlap depth 2 equals depth 0 and the no-mesh run,
and the families without a tensor-parallel port raise.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import ServeConfig as JServeConfig
from repro.config.registry import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro.serving.cost_model import PROFILES as JPROFILES
from repro.serving.cost_model import CostModel as JCostModel
from repro.serving.engine import Engine as JEngine

from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config, list_archs
from repro_torch.core.telemetry import Telemetry
from repro_torch.distributed.sharding import ServingGroup
from repro_torch.launch import serve as port_serve
from repro_torch.models.model import build_model
from repro_torch.serving.cost_model import CostModel, PROFILES
from repro_torch.serving.engine import check_ported
from repro_torch.serving.request import Request
from repro_torch.serving.sim import LengthDist, ServingSimulator

import _torch_tp_ranks as R

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"


@pytest.fixture(scope="module")
def results():
    """The rank runs (a subprocess, started first) and the JAX engine's
    runs on the same weights, done meanwhile."""
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{TESTS}")
    proc = subprocess.Popen([sys.executable, str(TESTS / "_torch_tp_ranks.py")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        jcfg = jax_config(R.ARCH, "reduced")
        jm = jax_build(jcfg, dtype=jnp.float32)
        jp = jax.tree.map(jnp.asarray, R.numpy_params())
        cost = JCostModel(jcfg, JPROFILES["a100x8"])

        def jax_run(paged, pool, swap, preempt, lens, max_new, seed):
            serve = JServeConfig(
                policy="static", b_max=4, max_new_tokens=8,
                kv_pool_tokens=pool, block_size=16, chunked_prefill=True,
                chunk_budget_tokens=24, n_prefill_lanes=2, paged_kv=paged,
                swap_space_blocks=swap, preempt=preempt)
            eng = JEngine(jm, jp, serve, max_context=R.MAX_CONTEXT,
                          buckets=(1, 2, 4), prefill_chunk=8, cost=cost)
            hs = [eng.submit(p, max_new_tokens=max_new, arrival_time=0.0)
                  for p in R.prompts_of(lens, seed, jcfg.vocab_size)]
            eng.run(max_steps=20_000)
            s = eng.summary()
            return {"tokens": [h.output_tokens for h in hs], "eta": eng.mem.eta,
                    "counters": {k: s[k] for k in R.COUNTERS}}

        single = jax_run(True, 256, 0, "auto", R.LENS, 8, 0)
        wide = jax_run(True, 160, 24, "swap", R.TIGHT, 12, 2)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
    return {"ranks": json.loads(line[len("RESULT"):]), "single": single,
            "wide": wide}


MESHES = ["1,2", "2,2"]


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_tokens_equal_the_jax_engine_on_every_rank(results, mesh,
                                                        layout):
    r = results["ranks"][mesh][layout]
    assert r["agree"]
    assert r["drained"] and r["finished"] == [0, 1, 2, 3, 4]
    assert r["tokens"] == results["single"]["tokens"]


@pytest.mark.parametrize("mesh", MESHES)
def test_pool_sharded_and_capacity_scales(results, mesh):
    cfg = get_config(R.ARCH, "reduced")
    for layout in ("paged", "contiguous"):
        r = results["ranks"][mesh][layout]
        assert r["counters"]["model_shards"] == 2
        assert r["eta"] == r["counters"]["pool_tokens"] \
            == 2 * results["single"]["eta"] == 512
        assert r["kv_heads"] == cfg.num_kv_heads // 2
    assert results["ranks"][mesh]["paged"]["counters"]["copy_rows"] == 0


def test_perchip_pool_equals_scaled_single_device(results):
    """A (1, 2) engine at a per-chip pool of 80 is counter for counter the
    JAX engine on one device at 160, under forced swaps."""
    r, w = results["ranks"]["1,2"]["perchip"], results["wide"]
    assert r["agree"]
    assert r["eta"] == w["eta"] == 160
    assert r["counters"]["swap_outs"] > 0
    assert r["tokens"] == w["tokens"]
    for k in ("swap_outs", "swap_ins", "preemptions", "oom_events",
              "admitted", "swap_out_bytes", "swap_in_bytes", "decode_steps"):
        assert r["counters"][k] == w["counters"][k], k


@pytest.mark.parametrize("scenario,pool,swap,policy", [
    ("diff_noswap", 96, 0, "memory"), ("diff_swap", 80, 24, "static")])
def test_differential_parity_under_mesh(results, scenario, pool, swap,
                                        policy):
    """The (2, 2) engine against the port's simulator on the same per-chip
    budget: the sim scales it by the same shard rule."""
    r = results["ranks"]["2,2"][scenario]
    cfg = get_config(R.ARCH, "reduced")
    serve = R.serve_cfg((2, 2), pool=pool, swap=swap,
                        preempt="swap" if swap else "auto", policy=policy)
    sim = ServingSimulator(cfg, serve, CostModel(cfg, PROFILES["a100x8"]),
                           LengthDist(mean_in=float(np.mean(R.TIGHT)),
                                      mean_out=12.0),
                           seed=0, prefill_chunk=8, max_context=R.MAX_CONTEXT)
    sim.tel = Telemetry()
    for i, pl in enumerate(R.TIGHT):
        sim.waiting.append(Request(
            rid=i, arrival_time=0.0, prompt_len=pl,
            max_new_tokens=min(12, R.MAX_CONTEXT - pl - 1)))
    sim._all.extend(sim.waiting)
    res = sim.run(max_steps=20_000)
    assert r["agree"] and r["drained"]
    assert r["eta"] == sim.mem.eta
    for k in ("admitted", "preemptions", "oom_events", "rejected",
              "swap_outs", "swap_ins", "swap_out_bytes", "swap_in_bytes",
              "sla_requests_met", "goodput_tokens"):
        assert r["counters"][k] == getattr(res, k), k
    done = [x.rid for x in sim._all
            if x.state.value == "finished" and not x.rejected]
    assert r["finished"] == sorted(done)
    assert r["rejected"] == sorted(x.rid for x in sim._all if x.rejected)
    assert r["sla_met"] == sorted(x.rid for x in sim._all if x.sla_met)
    if swap:
        assert r["counters"]["swap_outs"] > 0


def test_skewed_clock_sla_decides_alike_on_every_rank(results):
    """Rank 1 reads a clock 10^6 x fast: without the agreement its TBT
    samples pass the SLA while rank 0's do not, its batch windows part
    from rank 0's and their collectives stop matching. The ranks ran to
    the end with equal tokens, batch sizes and block tables after every
    interval."""
    r = results["ranks"]["1,2"]["skewed_sla"]
    assert r["agree"] and r["drained"]
    assert r["finished"] == [0, 1, 2, 3]


def test_cli_mesh_depth_two_equals_depth_zero_and_no_mesh(results):
    """`--mesh 1,2` through the CLI's engine builder (the ambient serving
    group), memory policy: depth 2 gives depth 0's tokens and counters,
    and those are the no-mesh run's (which serves the same random weights
    from --seed)."""
    cli = results["ranks"]["1,2"]["cli"]
    zero, two = cli["0"], cli["2"]
    assert zero["agree"] and two["agree"]
    assert zero["tokens"] == two["tokens"]
    assert zero["counters"] == two["counters"]
    args = port_serve.build_parser().parse_args(
        ["--device", "cpu", "--paged", "--chunked", "--lanes", "2",
         "--requests", "6", "--pool-tokens", "256", "--policy", "memory"])
    eng = port_serve.run(args)
    assert zero["tokens"] == [r.output_tokens for r in eng.cli_requests]
    assert zero["counters"]["model_shards"] == 2
    assert zero["counters"]["pool_tokens"] == 2 * eng.summary()["pool_tokens"]
    assert zero["counters"]["finished"] == 6


def _fake_group(m):
    return ServingGroup((1, m), 0, m, "gloo", None, None)


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if get_config(a, "reduced").family.value
                                  != "dense"])
def test_families_without_a_tp_port_raise_under_a_mesh(arch):
    cfg = get_config(arch, "reduced")
    with pytest.raises(NotImplementedError, match="later slice"):
        check_ported(ServeConfig(mesh_shape=(1, 2)), cfg)
    with pytest.raises(NotImplementedError, match="later slice"):
        build_model(cfg, torch.float32, "cpu", group=_fake_group(2))


def test_head_dim_fallback_raises():
    """Reduced granite has 2 kv-heads: at a model axis of 4 the JAX
    package stores K/V sharded on head_dim, which the port does not."""
    cfg = get_config(R.ARCH, "reduced")
    with pytest.raises(NotImplementedError, match="head_dim fallback"):
        check_ported(ServeConfig(mesh_shape=(1, 4)), cfg)
    # a mesh given to the engine needs a model on a group of that shape
    m = build_model(cfg, torch.float32, "cpu")
    from repro_torch.serving.engine import Engine
    with pytest.raises(ValueError, match="serving group"):
        Engine(m, m.init(0), ServeConfig(mesh_shape=(1, 2)), device="cpu")
