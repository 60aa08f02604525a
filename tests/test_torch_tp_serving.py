"""Tensor-parallel serving of the port (DESIGN §12), mirroring
tests/test_tp_serving.py.

A subprocess (`tests/_torch_tp_ranks.py`) runs the port's engine in rank
processes over gloo (`launch.mesh.spawn_ranks`, one process a rank): 2
ranks on a (1, 2) mesh, then 4 on a (2, 2) mesh, reduced granite-3-8b in
fp32 on weights drawn with numpy (also on a (1, 4) mesh, where its 2
kv-heads take the head_dim fallback), and the MoE, VLM, enc-dec, SSM and
hybrid families (reduced qwen2-moe-a2.7b, kimi-k2-1t-a32b,
llama-3.2-vision-90b, seamless-m4t-medium, a qwen2-moe of 5 experts,
which a model axis of 2 does not divide: its expert stacks replicate,
mamba2-2.7b, and recurrentgemma-9b, whose single kv-head takes the
fallback). Meanwhile the JAX package's single-device engine serves the
same requests on the same weights (and extras) in this process. The
assertions follow the JAX file's:

* tokens equal to the JAX engine's, on every rank, in both layouts, for
  every family;
* capacity: `model_shards` 2, the pool at twice the per-chip tokens, the
  rank's K/V at half the kv-heads, no row copy in the paged layout;
* a per-chip pool of 80 with swap behaves counter for counter like the
  JAX engine on one device at 160;
* (2, 2) parity with the port's simulator, swap off and on;

and the port's own: the families' counters equal the port's simulator's
at `model_shards` 2 (1 for the attention-free mamba2); the `sla` policy with rank 1's clock skewed decides
alike on both ranks (the engine agrees rank 0's measured values); after
an idle gap the mesh engine's TTFT is the no-mesh engine's (its clock is
agreed afresh, idle time included); a forward's all-reduces are the count
the layout gives; the CLI's --mesh path at overlap depth 2 equals depth 0
and the no-mesh run; a one-rank group serves each family's tokens bit for
bit; and the layouts the port does not serve yet (cross K/V under the
head_dim fallback, query heads that do not divide the axis) raise.
"""
import dataclasses
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

from repro_torch.analysis.graph_audit import allreduces, gathers
from repro_torch.config.base import ServeConfig
from repro_torch.config.registry import get_config
from repro_torch.core.memory_model import kv_shard_factor
from repro_torch.core.telemetry import Telemetry
from repro_torch.distributed.sharding import ServingGroup, tensor_parallel
from repro_torch.launch import serve as port_serve
from repro_torch.models.model import build_model
from repro_torch.params import from_jax_params
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.cost_model import CostModel, PROFILES
from repro_torch.serving.engine import Engine, check_ported
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
        def jax_run(paged, pool, swap, preempt, lens, max_new, seed,
                    name=None):
            """The JAX engine on `name`'s reduced config (default granite)
            and `R.numpy_params`, the requests' extras as the ranks draw
            them."""
            cfg = R.family_config(name) if name else None
            jcfg = R.family_config(name, jax_config) if name \
                else jax_config(R.ARCH, "reduced")
            jm = jax_build(jcfg, dtype=jnp.float32)
            jp = jax.tree.map(jnp.asarray, R.numpy_params(cfg))
            serve = JServeConfig(
                policy="static", b_max=4, max_new_tokens=8,
                kv_pool_tokens=pool, block_size=16, chunked_prefill=True,
                chunk_budget_tokens=24, n_prefill_lanes=2, paged_kv=paged,
                swap_space_blocks=swap, preempt=preempt)
            cross = R.extras_of(cfg or R.family_config(R.ARCH), len(lens),
                                seed + 100)
            key = "enc_frames" if jcfg.family.value == "encdec" \
                else "images"
            eng = JEngine(jm, jp, serve, max_context=R.MAX_CONTEXT,
                          buckets=(1, 2, 4), prefill_chunk=8,
                          cost=JCostModel(jcfg, JPROFILES["a100x8"]),
                          enc_len=R.ENC_LEN if cross[0] is not None else 0)
            hs = [eng.submit(p, max_new_tokens=max_new, arrival_time=0.0,
                             extras=None if x is None
                             else {key: jnp.asarray(x)})
                  for p, x in zip(R.prompts_of(lens, seed, jcfg.vocab_size),
                                  cross)]
            eng.run(max_steps=20_000)
            s = eng.summary()
            return {"tokens": [h.output_tokens for h in hs], "eta": eng.mem.eta,
                    "counters": {k: s[k] for k in R.COUNTERS}}

        single = jax_run(True, 256, 0, "auto", R.LENS, 8, 0)
        wide = jax_run(True, 160, 24, "swap", R.TIGHT, 12, 2)
        families = {name: jax_run(True, 256, 0, "auto", R.FAM_LENS, 8,
                                  R.FAM_SEED, name)
                    for name in R.FAMILIES}
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
    return {"ranks": json.loads(line[len("RESULT"):]), "single": single,
            "wide": wide, "families": families}


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


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_head_dim_fallback_tokens_equal_the_jax_engine(results, layout):
    """Reduced granite on a (1, 4) mesh: its 2 kv-heads do not divide the
    axis, so each rank's cache holds a quarter of head_dim of both
    kv-heads (gathered whole before each attention read); the JAX engine's
    tokens on every rank, and the pool at 4 x the per-chip tokens."""
    r = results["ranks"]["1,4"][layout]
    cfg = get_config(R.ARCH, "reduced")
    assert r["agree"] and r["drained"]
    assert r["tokens"] == results["single"]["tokens"]
    assert (r["kv_heads"], r["kv_dim"]) == (cfg.num_kv_heads,
                                            cfg.resolved_head_dim // 4)
    assert r["counters"]["model_shards"] == 4
    assert r["eta"] == r["counters"]["pool_tokens"] == 4 * 256


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", R.FAMILIES)
def test_family_tokens_equal_the_jax_engine_on_every_rank(results, name,
                                                          mesh, layout):
    """The MoE (experts cut on E, or replicated where 5 do not divide the
    axis), VLM, enc-dec, SSM and hybrid families on a mesh: the JAX
    single-device engine's tokens, on every rank (the ranks' batch sizes
    and block tables agreed after every interval)."""
    r = results["ranks"][mesh]["families"][f"{name} {layout}"]
    assert r["agree"] and r["drained"]
    assert r["finished"] == list(range(len(R.FAM_LENS)))
    assert r["tokens"] == results["families"][name]["tokens"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", R.FAMILIES)
def test_family_counters_equal_the_simulator(results, name, mesh):
    """The families' mesh runs against the port's simulator on the same
    per-chip budget (scaled by `model_shards`: 2, and 1 for mamba2, which
    has no token pool to shard), in both layouts; a rank holds half the
    kv-heads, in its cross K/V too, or under the head_dim fallback (the
    hybrid's single kv-head) half of head_dim."""
    cfg = R.family_config(name)
    shape = tuple(int(a) for a in mesh.split(","))
    for layout in ("paged", "contiguous"):
        r = results["ranks"][mesh]["families"][f"{name} {layout}"]
        serve = R.serve_cfg(shape, paged=layout == "paged")
        sim = ServingSimulator(cfg, serve, CostModel(cfg, PROFILES["a100x8"]),
                               LengthDist(mean_in=float(np.mean(R.FAM_LENS)),
                                          mean_out=8.0),
                               seed=0, prefill_chunk=8,
                               max_context=R.MAX_CONTEXT)
        sim.tel = Telemetry()
        for i, pl in enumerate(R.FAM_LENS):
            sim.waiting.append(Request(rid=i, arrival_time=0.0,
                                       prompt_len=pl, max_new_tokens=8))
        sim._all.extend(sim.waiting)
        res = sim.run(max_steps=20_000)
        for k in ("admitted", "preemptions", "oom_events", "rejected",
                  "sla_requests_met", "goodput_tokens"):
            assert r["counters"][k] == getattr(res, k), (layout, k)
        shards = kv_shard_factor(cfg, 2)
        assert shards == (1 if name == "mamba2-2.7b" else 2)
        assert r["eta"] == sim.mem.eta == r["counters"]["pool_tokens"] \
            == 256 * shards
        assert r["counters"]["model_shards"] == shards
        if "kv_heads" in r:
            KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
            assert (r["kv_heads"], r["kv_dim"]) == (
                (KV // 2, hd) if KV % 2 == 0 else (KV, hd // 2))
        if "cross_heads" in r:
            assert r["cross_heads"] == cfg.num_kv_heads // 2


@pytest.mark.parametrize("name", R.FAMILIES)
def test_family_forward_allreduces_are_the_layouts(results, name):
    """A (1, 2) rank's first chunk with extras and its decode step, traced
    (`graph_audit.OpTrace`): their all-reduces and gathers are
    `allreduces`' and `gathers`' counts for the rank's layout (the
    encoder's too on a first chunk)."""
    r = results["ranks"]["1,2"]["families"][f"{name} paged"]
    cfg = R.family_config(name)
    tp = tensor_parallel(cfg, _fake_group(2))
    extras = cfg.family.value in ("vlm", "encdec")
    assert r["allreduces"] == {"prefill": allreduces(cfg, tp, extras),
                               "decode": allreduces(cfg, tp),
                               "prefill_gathers": gathers(cfg, tp),
                               "decode_gathers": gathers(cfg, tp)}


def test_allreduce_counts_of_the_full_configs_at_two():
    """The counts chip_smoke's tp (a) holds the card's audit to, at a model
    axis of 2: 2 a layer plus the vocab-cut embedding and head."""
    def count(arch, extras=False, **cut):
        cfg = dataclasses.replace(get_config(arch, "full"), **cut)
        return allreduces(cfg, tensor_parallel(cfg, _fake_group(2)), extras)

    assert count("qwen2-moe-a2.7b") == 24 * 2 + 2
    assert count("seamless-m4t-medium") == 12 * 4 + 2
    assert count("seamless-m4t-medium", True) == 12 * 4 + 2 + 12 * 2
    assert count("llama-3.2-vision-90b", num_layers=16,
                 num_cross_layers=4) == 16 * 2 + 4 * 2 + 2
    assert count("granite-3-8b") == 40 * 2       # an odd vocab: not cut
    assert count("mamba2-2.7b") == 64 * 2 + 2
    assert count("recurrentgemma-9b") == 38 * 2 + 2


def test_gather_counts_of_the_hybrid():
    """recurrentgemma-9b's gathers a forward: one a recurrent layer (26),
    and at m > 1, where its single kv-head takes the head_dim fallback,
    two an attention layer (12); none in the other families."""
    cfg = get_config("recurrentgemma-9b", "full")
    assert gathers(cfg, tensor_parallel(cfg, _fake_group(1))) == 26
    assert gathers(cfg, tensor_parallel(cfg, _fake_group(2))) == 26 + 24
    for arch in ("mamba2-2.7b", "granite-3-8b"):
        cfg = get_config(arch, "full")
        assert gathers(cfg, tensor_parallel(cfg, _fake_group(2))) == 0


def test_clock_after_an_idle_gap_matches_the_no_mesh_engine(results,
                                                            monkeypatch):
    """Two requests served and drained, an idle gap of R.GAP_S (the
    engine's clock then stopped that far ahead, so a TTFT is the stamps'
    lag alone), one more request: the (1, 2) engine's TTFT for it is
    within 0.25 s of the no-mesh engine's (its arrival is stamped with
    rank 0's clock read after the gap, not the one agreed at the drain,
    which made it R.GAP_S late), every rank stamped the same values, the
    submit agreed the clock once and every busy interval kept its one
    broadcast."""
    r = results["ranks"]["1,2"]["clock"]
    cfg = get_config(R.ARCH, "reduced")
    model = build_model(cfg, torch.float32, "cpu")
    eng = Engine(model, from_jax_params(R.numpy_params()),
                 R.serve_cfg(()), max_context=R.MAX_CONTEXT,
                 buckets=(1, 2, 4), prefill_chunk=8, device="cpu")
    a, b, c = R.prompts_of([20, 24, 18], 7, cfg.vocab_size)
    hs = [eng.submit(a, max_new_tokens=4), eng.submit(b, max_new_tokens=4)]
    eng.run()
    monkeypatch.setattr(engine_mod, "time",
                        R.StoppedClock(R.time.perf_counter() + R.GAP_S))
    last = eng.submit(c, max_new_tokens=4)
    eng.run()
    ttft = last.first_token_time - last.arrival_time
    assert abs(r["ttft"] - ttft) < 0.25, (r["ttft"], ttft)
    assert r["stamps_agree"]
    assert r["submit_broadcasts"] == 1
    assert r["busy_step_broadcasts"] and \
        set(r["busy_step_broadcasts"]) == {1}
    assert r["tokens"] == [h.output_tokens for h in hs + [last]]


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


class _OneRank(ServingGroup):
    """A (1, 1) serving group without a process group: a one-rank
    all-reduce and agreement are the identity."""

    def __init__(self):
        super().__init__((1, 1), 0, 1, "gloo", None, None)

    def all_reduce(self, x):
        return x

    def gather(self, x):
        return x

    def agree(self, values):
        return list(values)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-medium", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
def test_tp_families_build_and_serve_on_a_group(arch):
    """The MoE, VLM, enc-dec, SSM and hybrid families pass `check_ported`
    on a (1, 2) mesh, reduced and full, and build a rank's model (half the
    heads, or the hybrid's single kv-head on half of head_dim; the
    layout's splits); on a one-rank group the engine serves the no-mesh
    engine's tokens and counters bit for bit (a one-rank all-reduce and
    gather are the identity), extras included."""
    cfg = get_config(arch, "reduced")
    check_ported(ServeConfig(mesh_shape=(1, 2)), cfg)
    check_ported(ServeConfig(mesh_shape=(1, 2)), get_config(arch, "full"))
    half = build_model(cfg, torch.float32, "cpu", group=_fake_group(2))
    KV = cfg.num_kv_heads
    assert half.tp.hd_split == (KV % 2 != 0)
    assert half.local_cfg.num_kv_heads == (KV if KV % 2 else KV // 2)
    assert half.local_cfg.num_heads == cfg.num_heads // 2
    assert half.tp.mlp_split or cfg.moe is not None
    if cfg.moe is not None:
        assert half.tp.expert_split and half.tp.shared_split
    params = from_jax_params(R.numpy_params(cfg))
    cross = R.extras_of(cfg, 3, 9)
    key = "enc_frames" if cfg.family.value == "encdec" else "images"
    runs = []
    for group in (None, _OneRank()):
        model = build_model(cfg, torch.float32, "cpu", group=group)
        eng = Engine(model, model.shard(params),
                     R.serve_cfg((1, 1) if group else ()),
                     max_context=R.MAX_CONTEXT, buckets=(1, 2, 4),
                     prefill_chunk=8, device="cpu",
                     enc_len=R.ENC_LEN if cross[0] is not None else 0)
        hs = [eng.submit(p, max_new_tokens=6, arrival_time=0.0,
                         extras=None if x is None else {key: x})
              for p, x in zip(R.prompts_of([18, 26, 12], 9, cfg.vocab_size),
                              cross)]
        eng.run()
        s = eng.summary()
        runs.append(([h.output_tokens for h in hs],
                     {k: s[k] for k in R.COUNTERS if k != "pool_tokens"}))
    assert runs[0] == runs[1]


def test_head_dim_fallback_raises():
    """The head_dim fallback (K/V stored sharded on head_dim where the
    kv-heads do not divide the axis) is served for self-attention
    (reduced granite's 2 kv-heads at a model axis of 4) and for the cross
    K/V (reduced llama-3.2-vision's 2 kv-heads at 4, served by
    tests/test_torch_tp_layouts.py); what still raises is an axis neither
    the kv-heads nor head_dim divide (granite's 2 and 32 at 3), and a
    mesh given to the engine without a model on a group of its shape."""
    cfg = get_config(R.ARCH, "reduced")
    check_ported(ServeConfig(mesh_shape=(1, 4)), cfg)
    check_ported(ServeConfig(mesh_shape=(1, 4)),
                 get_config("llama-3.2-vision-90b", "reduced"))
    with pytest.raises(NotImplementedError,
                       match="neither its 2 kv-heads nor head_dim 32"):
        check_ported(ServeConfig(mesh_shape=(1, 3)), cfg)
    # a mesh given to the engine needs a model on a group of that shape
    m = build_model(cfg, torch.float32, "cpu")
    from repro_torch.serving.engine import Engine
    with pytest.raises(ValueError, match="serving group"):
        Engine(m, m.init(0), ServeConfig(mesh_shape=(1, 2)), device="cpu")
