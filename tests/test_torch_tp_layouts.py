"""The tensor-parallel layouts the port once refused, against the JAX
package: query heads cut across the model axis, cross K/V on the head_dim
fallback, and the sequence-sharded batch-1 decode with its partial
flash-decode and combine kernels.

A subprocess (`tests/_torch_tp_layouts_ranks.py`, one spawn of 8 gloo
ranks) serves and trains them on the CPU in fp32; meanwhile the JAX
package serves the same requests on one device, on the same weights, in
this process.

* Split heads and the cross fallback (reduced configs whose 6 or 12 query
  heads, 2 or 3 kv-heads do not divide a model axis of 4; reduced
  llama-3.2-vision; a seamless variant so cut): the JAX engine's greedy
  tokens on (1, 4) and (2, 4) meshes in both cache layouts, the port
  simulator's counters at `model_shards` 4, a forward's all-reduces and
  gathers the layout's (`graph_audit`), and on (1, 4) a training step's
  gradients each rank's slice of one device's within 2e-4.
* The sequence-sharded decode: the plain partial + combine against the
  plain decode and the JAX `ref.decode_attention_ref` (ragged rows, a
  wrapped ring, a rank with no visible key, padding rows), and the decode
  logits of reduced granite, mistral-nemo on a sliding window whose ring
  wraps, and recurrentgemma on 2 and 4 data ranks and on (2, 2) (where
  recurrentgemma's kv-head takes the fallback) against the JAX
  `decode_step` on the whole cache at rtol = atol = 2e-4.
* `check_tp` serves the registry's layouts the JAX package serves
  (starcoder2-7b at m = 8 and 16, qwen1.5-32b and llama-3.2-vision-90b at
  16), and still refuses a model axis neither the kv-heads nor head_dim
  divide.
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
from repro.kernels import ref as jref
from repro.models.model import build_model as jax_build
from repro.serving.cost_model import PROFILES as JPROFILES
from repro.serving.cost_model import CostModel as JCostModel
from repro.serving.engine import Engine as JEngine

from repro_torch.analysis.graph_audit import allreduces, gathers
from repro_torch.config.registry import get_config
from repro_torch.core.telemetry import Telemetry
from repro_torch.distributed.sharding import (ServingGroup, check_tp,
                                              head_span, local_config,
                                              q_gathered, tensor_parallel)
from repro_torch.kernels import ops, ref
from repro_torch.models.backbone import phys_cache_len
from repro_torch.serving.cost_model import CostModel, PROFILES
from repro_torch.serving.request import Request
from repro_torch.serving.sim import LengthDist, ServingSimulator

import _torch_tp_layouts_ranks as LR
import _torch_tp_ranks as R

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
TOL = dict(rtol=2e-4, atol=2e-4)
MESHES = ["1,4", "2,4"]
SEQ_MESHES = ["2,1", "4,1", "2,2"]


def _jax_tokens(name):
    """The JAX single-device engine on a `LR.LAYOUTS` config: the requests
    of `_torch_tp_ranks.FAM_LENS`, with extras where the family takes
    them."""
    jcfg = LR.layout_config(name, jax_config)
    cfg = LR.layout_config(name)
    jm = jax_build(jcfg, dtype=jnp.float32)
    jp = jax.tree.map(jnp.asarray, R.numpy_params(cfg))
    serve = JServeConfig(policy="static", b_max=4, max_new_tokens=8,
                         kv_pool_tokens=256, block_size=16,
                         chunked_prefill=True, chunk_budget_tokens=24,
                         n_prefill_lanes=2, paged_kv=True)
    cross = R.extras_of(cfg, len(R.FAM_LENS), R.FAM_SEED + 100)
    key = "enc_frames" if jcfg.family.value == "encdec" else "images"
    eng = JEngine(jm, jp, serve, max_context=R.MAX_CONTEXT,
                  buckets=(1, 2, 4), prefill_chunk=8,
                  cost=JCostModel(jcfg, JPROFILES["a100x8"]),
                  enc_len=R.ENC_LEN if cross[0] is not None else 0)
    hs = [eng.submit(p, max_new_tokens=8, arrival_time=0.0,
                     extras=None if x is None else {key: jnp.asarray(x)})
          for p, x in zip(R.prompts_of(R.FAM_LENS, R.FAM_SEED,
                                       jcfg.vocab_size), cross)]
    eng.run(max_steps=20_000)
    return [h.output_tokens for h in hs]


def _jax_decode_logits(name):
    """The JAX `decode_step` on one whole cache: the prompt filled token by
    token, then the logits of the `LR.N_DECODE` steps the ranks take."""
    jcfg = LR.seq_config(name, jax_config)
    cfg = LR.seq_config(name)
    jm = jax_build(jcfg, dtype=jnp.float32)
    jp = jax.tree.map(jnp.asarray, R.numpy_params(cfg))
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(1, LR.SEQ_CONTEXT)
    toks = LR.seq_tokens(cfg)
    out = []
    for t in range(LR.N_PROMPT + LR.N_DECODE):
        lg, cache = step(jp, jnp.asarray(toks[t:t + 1], jnp.int32),
                         jnp.asarray([t], jnp.int32), cache)
        if t >= LR.N_PROMPT:
            out.append(np.asarray(lg[0]))
    return np.stack(out)


@pytest.fixture(scope="module")
def results():
    """The rank runs (a subprocess, started first) and the JAX runs on the
    same weights, done meanwhile."""
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{TESTS}")
    proc = subprocess.Popen(
        [sys.executable, str(TESTS / "_torch_tp_layouts_ranks.py")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        tokens = {name: _jax_tokens(name) for name in LR.LAYOUTS}
        logits = {name: _jax_decode_logits(name) for name in LR.SEQ}
        out, err = proc.communicate(timeout=420)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
    return {"ranks": json.loads(line[len("RESULT"):]), "tokens": tokens,
            "logits": logits}


def _group(m, rank=0):
    return ServingGroup((1, m), rank, m, "gloo", None, None)


# ---------------------------------------------------------------------------
# the layouts check_tp now takes


@pytest.mark.parametrize("arch,m", [("starcoder2-7b", 8),
                                    ("starcoder2-7b", 16),
                                    ("qwen1.5-32b", 16),
                                    ("llama-3.2-vision-90b", 16)])
def test_registry_layouts_are_served(arch, m):
    """No refusal: each rank's head span covers its flat `wq` columns
    (whole heads, and heads read as whole kv groups where a span reads
    more than one kv-head), the spans cover every head, and the layout
    gathers q exactly where a rank's columns are not its span."""
    cfg = get_config(arch)
    check_tp(cfg, m)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G = H // KV
    covered = set()
    for r in range(m):
        h0, h1 = head_span(cfg, m, r)
        assert h0 * hd <= r * H * hd // m and (r + 1) * H * hd // m \
            <= h1 * hd
        if h0 // G != (h1 - 1) // G:
            assert h0 % G == 0 and h1 % G == 0
        covered.update(range(h0, h1))
        lc = local_config(cfg, m, r)
        assert (lc.num_heads, lc.num_kv_heads) == (h1 - h0, KV)
        tp = tensor_parallel(cfg, _group(m, r))
        assert tp.hd_split and tp.heads == (h0, h1)
    assert covered == set(range(H))
    assert q_gathered(cfg, m) == (arch != "llama-3.2-vision-90b")


def test_neither_kv_heads_nor_head_dim_dividing_is_refused():
    """The refusal that remains: reduced granite's 2 kv-heads and head_dim
    32 on a model axis of 3."""
    with pytest.raises(NotImplementedError,
                       match="neither its 2 kv-heads nor head_dim 32"):
        check_tp(get_config("granite-3-8b", "reduced"), 3)


# ---------------------------------------------------------------------------
# split heads and the cross fallback on gloo meshes


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", LR.LAYOUTS)
def test_layout_tokens_equal_the_jax_engine(results, name, mesh, layout):
    r = results["ranks"][mesh][f"{name} {layout}"]
    assert r["agree"] and r["drained"]
    assert r["finished"] == list(range(len(R.FAM_LENS)))
    assert r["tokens"] == results["tokens"][name]
    KV, hd = LR.layout_config(name).num_kv_heads, \
        LR.layout_config(name).resolved_head_dim
    assert (r["kv_heads"], r["kv_dim"]) == (KV, hd // 4)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", LR.LAYOUTS)
def test_layout_counters_equal_the_simulator(results, name, mesh):
    """The port's simulator on the same per-chip budget, scaled by
    `model_shards` 4 (the head_dim fallback shards the pool)."""
    cfg = LR.layout_config(name)
    shape = tuple(int(a) for a in mesh.split(","))
    for layout in ("paged", "contiguous"):
        r = results["ranks"][mesh][f"{name} {layout}"]
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
        assert r["counters"]["model_shards"] == 4
        assert r["eta"] == sim.mem.eta == r["counters"]["pool_tokens"] \
            == 256 * 4


@pytest.mark.parametrize("name", LR.LAYOUTS)
def test_layout_collectives_are_the_layouts(results, name):
    """A first chunk's and a decode step's all-reduces and gathers, traced
    on rank 0 of (1, 4): `graph_audit.allreduces` and `gathers` of the
    layout, the q gather where it splits heads (the cross K/V's and the
    encoder's on the first chunk)."""
    cfg = LR.layout_config(name)
    tp = tensor_parallel(cfg, _group(4))
    extras = cfg.family.value in ("vlm", "encdec")
    r = results["ranks"]["1,4"][f"{name} collectives"]
    assert results["ranks"]["1,4"][f"{name} q_gather"] == tp.q_gather \
        == (name != "llama-3.2-vision-90b")
    assert r == {"prefill": allreduces(cfg, tp, extras),
                 "decode": allreduces(cfg, tp),
                 "prefill_gathers": gathers(cfg, tp, extras),
                 "decode_gathers": gathers(cfg, tp)}


@pytest.mark.parametrize("name", LR.LAYOUTS)
def test_layout_training_gives_each_rank_its_gradient_slice(results, name):
    r = results["ranks"]["train"][name]
    assert abs(r["loss"] - r["loss_one"]) <= 2e-4 * abs(r["loss_one"])
    worst = max(r["grad_gaps"], key=r["grad_gaps"].get)
    assert r["grad_gaps"][worst] <= 2e-4, (worst, r["grad_gaps"][worst])


# ---------------------------------------------------------------------------
# the sequence-sharded decode


def _cut(R_, S):
    """Contiguous slot ranges of S over R_ ranks."""
    return [slice(i * S // R_, (i + 1) * S // R_) for i in range(R_)]


def _partials_then_combine(q, k, v, qp, kp, parts, window):
    o, ml = zip(*(ref.decode_attention_partial_ref(
        q, k[:, sl], v[:, sl], qp, kp[:, sl], window=window)
        for sl in _cut(parts, k.shape[1])))
    return ref.attention_combine_ref(torch.stack(o), torch.stack(ml),
                                     dtype=q.dtype)


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("window", [0, 12])
def test_partial_and_combine_equal_the_whole_decode(parts, window):
    """Ragged rows (8, 23 and 32 of 32 slots filled, one padding row) over
    a ring that has wrapped (row 3 holds positions 40..71 in ring order),
    cut into `parts` contiguous slot ranges: the combined partials equal
    the port's plain decode and the JAX `ref.decode_attention_ref` within
    2e-4. With 4 parts, row 0's last three ranks see no key."""
    rng = np.random.RandomState(parts * 10 + window)
    B, H, KV, hd, S = 5, 8, 2, 16, 32
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, KV, hd))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KV, hd))
                         .astype(np.float32))
    kp = np.full((B, S), -1, np.int32)
    qp = np.array([7, 22, 31, 71, -1], np.int32)
    for b, n in enumerate((8, 23, 32)):
        kp[b, :n] = np.arange(n)
    for p in range(40, 72):
        kp[3, p % S] = p
    kp_t, qp_t = torch.from_numpy(kp), torch.from_numpy(qp)
    got = _partials_then_combine(q, k, v, qp_t, kp_t, parts, window)
    want = ref.decode_attention_ref(q, k, v, qp_t, kp_t, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    jwant = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(qp), jnp.asarray(kp),
        window=window))
    np.testing.assert_allclose(got[:4].numpy(), jwant[:4], **TOL)
    assert float(got[4].abs().max()) == 0.0       # the padding row
    if parts == 4:
        _, ml = ref.decode_attention_partial_ref(
            q, k[:, 8:16], v[:, 8:16], qp_t, kp_t[:, 8:16], window=window)
        assert float(ml[0, :, 1].abs().max()) == 0.0
        assert float(ml[0, :, 0].max()) == float(np.float32(ref.NEG_INF))


def test_partial_ops_dispatch_to_the_plain_versions_on_the_cpu():
    """`ops` runs the plain versions for CPU tensors (and counts no
    launch); bf16 inputs give fp32 partials and a bf16 combine."""
    ops.reset_launches()
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.standard_normal((1, 4, 32)).astype(np.float32)
                         ).bfloat16()
    k = torch.from_numpy(rng.standard_normal((1, 16, 1, 32))
                         .astype(np.float32)).bfloat16()
    kp = torch.arange(16, dtype=torch.int32)[None]
    o, ml = ops.decode_attention_partial(q, k, k, torch.tensor([15]), kp)
    assert o.dtype == ml.dtype == torch.float32
    assert ml.shape == (1, 4, 2)
    out = ops.attention_combine(o[None], ml[None], dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    want = ref.decode_attention_ref(q, k, k, torch.tensor([15]), kp)
    np.testing.assert_allclose(out.float().numpy(), want.float().numpy(),
                               rtol=2e-2, atol=2e-2)
    assert ops.LAUNCHES["decode_attention_partial"] == 0
    assert ops.LAUNCHES["attention_combine"] == 0


@pytest.mark.parametrize("mesh", SEQ_MESHES)
@pytest.mark.parametrize("name", LR.SEQ)
def test_seq_sharded_decode_logits_equal_the_jax_decode(results, name, mesh):
    """Each data rank holds 1/data of the cache's slots; the decode logits
    equal the JAX `decode_step` on the whole cache, and each step gathers
    once an attention layer over the data axis (plus the fallback's
    gathers over the model axis)."""
    r = results["ranks"]["seq " + mesh][name]
    D, m = (int(a) for a in mesh.split(","))
    cfg = LR.seq_config(name)
    np.testing.assert_allclose(np.asarray(r["logits"]),
                               results["logits"][name], **TOL)
    tp = tensor_parallel(cfg, ServingGroup((D, m), 0, D * m, "gloo", None,
                                           None))
    assert r["gathers"] == [gathers(cfg, tp, seq=True)] * LR.N_DECODE
    assert r["slots"] * D == phys_cache_len(cfg, LR.SEQ_CONTEXT)
