"""The port's serving shardings (`repro_torch.distributed.sharding`)
against the JAX package's rules, and the arithmetic of a rank's shard.

* The DESIGN §5 name table and the divisibility check, leaf for leaf
  against `repro.distributed.sharding._spec_for` and `_validate` on a
  fake mesh (as tests/test_sharding.py calls `_validate`), for every
  param leaf of all ten archs, reduced and full (the port's params built
  on the meta device), at model axes 2, 4 and 16; the serving specs as
  `serve_param_shardings` strips them.
* The starcoder2 36-heads case.
* Each rank's slices, put back together, are the whole params.
* One layer at TP 2: the two ranks' partial sums of the attention (through
  a rank-local cache of half the kv-heads) and of the SwiGLU, added,
  within 1e-5 of the whole layer's; so too a MoE layer's (each rank's
  experts and its shared expert's columns), a cross layer's (the rank's
  cross K/V heads, the VLM's gate) and an encoder layer's; the
  vocab-parallel embedding and head made whole the same way.
* The MoE's layout: experts cut on E where the axis divides it,
  replicated where not (one all-reduce either way).
* A rank's weights drawn cut (`model.init_shard`) are its slices of the
  whole weights, bit for bit.
"""
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.config.registry import get_config as jax_config
from repro.distributed.sharding import _spec_for, _validate
from repro.distributed.sharding import kv_head_axes as jax_kv_head_axes

from repro_torch.config.registry import get_config, list_archs
from repro_torch.core.memory_model import kv_shard_factor
from repro_torch.distributed.sharding import (TP_FAMILIES, TensorParallel,
                                              check_tp, kv_head_axes,
                                              local_config, serve_spec,
                                              shard_params, spec_for,
                                              tensor_parallel, validate)
from repro_torch.models.model import init_shard
from repro_torch.models.backbone import init_cache, init_paged_cache
from repro_torch.models import layers as L
from repro_torch.models.backbone import init_params, layer_params
from repro_torch.params import named_leaves

MODEL_AXES = (2, 4, 16)


class FakeMesh:
    axis_names = ("pod", "data", "model")

    def __init__(self, m):
        self.shape = {"pod": 2, "data": 16, "model": m}


def _strip(ax):
    """`serve_param_shardings`' strip, written out here: it is an inner
    function of the JAX package's."""
    if isinstance(ax, tuple):
        keep = tuple(a for a in ax if a == "model")
        return keep[0] if keep else None
    return ax if ax == "model" else None


@pytest.mark.parametrize("variant", ["reduced", "full"])
@pytest.mark.parametrize("arch", list_archs())
def test_rule_table_matches_the_jax_package(arch, variant):
    cfg, jcfg = get_config(arch, variant), jax_config(arch, variant)
    leaves = list(named_leaves(init_params(cfg, device="meta")))
    assert leaves
    for m in MODEL_AXES:
        mesh = FakeMesh(m)
        for name, leaf in leaves:
            shape = tuple(leaf.shape)
            for fsdp in (("data",), ("pod", "data")):
                theirs = tuple(_spec_for(name, leaf.ndim, jcfg, fsdp))
                ours = spec_for(name, leaf.ndim, cfg, fsdp)
                assert ours == theirs, (name, fsdp)
                assert validate(ours, shape, mesh.shape) \
                    == tuple(_validate(P(*theirs), shape, mesh)), (name, m)
            served = _validate(P(*(_strip(ax) for ax in theirs)), shape,
                               mesh)
            assert serve_spec(name, shape, cfg, m) == tuple(served), \
                (name, m)


@pytest.mark.parametrize("arch", list_archs())
def test_cache_axes_and_per_rank_cache_shapes(arch):
    """The cache rule (`kv_head_axes`) is the JAX package's, and agrees
    with the pool's shard count (`kv_shard_factor`); where the port serves
    a mesh, a rank's caches hold KV/m heads at the same head_dim
    (`serve_cache_shardings`' shards)."""
    for variant in ("reduced", "full"):
        cfg = get_config(arch, variant)
        KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        for m in MODEL_AXES:
            axes = kv_head_axes(m, KV, hd)
            assert axes == tuple(jax_kv_head_axes(FakeMesh(m), KV, hd))
            if cfg.kv_bytes_per_token():
                assert kv_shard_factor(cfg, m) \
                    == (m if axes != (None, None) else 1)
            if cfg.family not in TP_FAMILIES or axes[0] is None:
                with pytest.raises(NotImplementedError):
                    check_tp(cfg, m)
                continue
            lcfg = local_config(cfg, m)
            for c in (init_cache(lcfg, 2, 32, device="meta", enc_len=5),
                      init_paged_cache(lcfg, 4, 16, device="meta",
                                       enc_len=5)):
                assert c["k"].shape[-2:] == (KV // m, hd)
                assert c["k"].shape[0] == cfg.num_layers
                if "cross_k" in c:
                    assert c["cross_k"].shape[-3:] == (5, KV // m, hd)


def test_starcoder2_36_heads_do_not_divide_16():
    """36 heads on a 16-way model axis must not shard (the JAX file's
    case); the port, which splits no head, refuses starcoder2 at 16 (its 4
    kv-heads would need the head_dim fallback) and serves it at 4."""
    sizes = {"data": 16, "model": 16}
    assert validate((None, "model"), (10, 36), sizes) == (None, None)
    assert validate((None, "model"), (10, 64), sizes) == (None, "model")
    cfg = get_config("starcoder2-7b", "full")
    assert cfg.num_heads == 36
    with pytest.raises(NotImplementedError, match="head_dim fallback"):
        check_tp(cfg, 16)
    assert local_config(cfg, 4).num_heads == 9


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", list_archs())
def test_shards_concatenate_to_the_whole_params(arch, m):
    cfg = get_config(arch, "reduced")
    whole = init_params(cfg, 0, torch.float32, "cpu")
    shards = [dict(named_leaves(shard_params(whole, cfg, r, m)))
              for r in range(m)]
    split = 0
    for name, w in named_leaves(whole):
        spec = serve_spec(name, tuple(w.shape), cfg, m)
        parts = [s[name] for s in shards]
        if "model" in spec:
            split += 1
            axis = spec.index("model")
            assert all(p.shape[axis] * m == w.shape[axis] for p in parts)
            assert torch.equal(torch.cat(parts, axis), w), name
        else:
            assert all(p is w for p in parts), name
    assert split > 0


class _SumGroup:
    """A stand-in group for one rank whose all-reduce is the identity: the
    test adds the ranks' outputs itself."""

    def __init__(self, rank, m):
        self.tp_rank, self.model_size = rank, m

    def all_reduce(self, x):
        return x


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen1.5-32b",
                                  "mistral-nemo-12b", "starcoder2-7b",
                                  "qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-medium"])
def test_tp2_layer_partial_sums_add_up_to_the_whole_layer(arch):
    """The self layer's attention and its SwiGLU or MoE; the VLM's gated
    cross layer and the enc-dec cross and encoder layers: each rank's
    output with the all-reduce left out (`_SumGroup`), added over the
    ranks, is the whole layer's within 1e-5."""
    cfg = get_config(arch, "reduced")
    m = 2
    check_tp(cfg, m)
    rng = np.random.RandomState(0)
    whole = init_params(cfg, 0, torch.float32, "cpu")
    for name, t in named_leaves(whole):
        # numpy draws for every leaf: the biases, norms and gates non-zero
        scale = 0.1 if t.dim() <= 2 else 1 / np.sqrt(t.shape[-2])
        t.copy_(torch.from_numpy(
            (rng.standard_normal(t.shape) * scale).astype(np.float32)))
    lcfg = local_config(cfg, m)
    B, T, S = 2, 5, 16
    x = torch.from_numpy(rng.standard_normal((B, T, cfg.d_model))
                         .astype(np.float32))
    pos = torch.arange(T, dtype=torch.int32).expand(B, T) + 3
    if cfg.family.value in ("moe", "vlm", "encdec"):
        _other_layers_add_up(cfg, whole, x, pos, m, rng)
        if cfg.family.value != "vlm":
            return

    def attn(p, c):
        KV, hd = c.num_kv_heads, c.resolved_head_dim
        k = torch.zeros(B, S, KV, hd)
        v = torch.zeros(B, S, KV, hd)
        kpos = torch.full((B, S), -1, dtype=torch.int32)
        widx = L.cache_write_index(pos, S)
        L.cache_put(kpos, widx, pos)
        return L.self_attention_cached(p["attn"], x, pos, k, v, kpos, widx, c)

    lw = layer_params(whole["layers"], 0)
    want_a, want_y = attn(lw, cfg), L.mlp(lw["mlp"], x)
    got_a = got_y = 0
    for r in range(m):
        lr = layer_params(shard_params(whole, cfg, r, m)["layers"], 0)
        assert lr["attn"]["wq"].shape[-1] == lcfg.num_heads \
            * lcfg.resolved_head_dim
        got_a = got_a + attn(lr, lcfg)
        got_y = got_y + L.mlp(lr["mlp"], x)
    assert float((got_a - want_a).abs().max()) < 1e-5
    assert float((got_y - want_y).abs().max()) < 1e-5


def _other_layers_add_up(cfg, whole, x, pos, m, rng):
    """The MoE layer (routed experts and the shared expert), the cross
    layer (the rank's cross K/V from its wk / wv columns; the VLM's tanh
    gate on the sum) and the encoder layer (bidirectional attention and
    its SwiGLU) at TP m, against the whole layers."""
    from repro_torch.models.backbone import encode

    lcfg = local_config(cfg, m)
    shards = [shard_params(whole, cfg, r, m) for r in range(m)]
    tps = [tensor_parallel(cfg, _SumGroup(r, m)) for r in range(m)]
    fam = cfg.family.value
    checked = []

    def add_up(key, fn):
        want = fn(layer_params(whole[key], 0), cfg, None)
        got = sum(fn(layer_params(sh[key], 0), lcfg, tp)
                  for sh, tp in zip(shards, tps))
        assert float((got - want).abs().max()) < 1e-5, key
        checked.append(key)

    if fam == "moe":
        assert all(tp.expert_split and tp.shared_split for tp in tps)
        add_up("layers", lambda lp, c, tp: L.moe_apply(
            lp["moe"], x, c, no_drop=True, tp=tp)[0])
    else:
        enc = torch.from_numpy(rng.standard_normal((x.shape[0], 7,
                                                    cfg.d_model))
                               .astype(np.float32))
        key = "cross_layers" if fam == "vlm" else "dec_cross"

        def cross(lp, c, tp):
            k, v = L.cross_kv(lp["attn"], enc, c)
            assert k.shape[-2] == c.num_kv_heads
            a = L.cross_attention(lp["attn"], x, k, v, c,
                                  gated=fam == "vlm", tp=tp)
            return a + L.mlp(lp["mlp"], x, tp)

        add_up(key, cross)
    if fam == "encdec":
        add_up("enc_layers", lambda lp, c, tp: L.encoder_attention(
            lp["attn"], x, pos, c, tp) + L.mlp(lp["mlp"], x, tp))
        # the whole encoder: every rank returns the whole output once the
        # group sums each layer (here a one-rank group's identity)
        one = tensor_parallel(cfg, _SumGroup(0, 1))
        want = encode(whole, x, cfg)
        assert float((encode(whole, x, one.cfg, one) - want).abs().max()) \
            == 0.0
    assert checked


@pytest.mark.parametrize("E,m,split", [(4, 2, True), (6, 4, False),
                                       (5, 2, False)])
def test_moe_experts_cut_on_e_or_replicated(E, m, split):
    """The expert stacks are cut on E where m divides it (rank r applies
    experts [r·E/m, (r+1)·E/m)) and replicated where not, as the JAX
    package's `_validate` leaves them; the shared expert is cut on its
    d_ff either way. A replicated routed sum is whole on every rank and
    joins after the one all-reduce of the shared expert's partial sum, so
    the ranks' outputs (the group's sum given back to each) are the whole
    layer's within 1e-5."""
    import dataclasses

    base = get_config("qwen2-moe-a2.7b", "reduced")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, num_experts=E))
    whole = init_params(cfg, 1, torch.float32, "cpu")
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    lw = layer_params(whole["layers"], 0)["moe"]
    want, _ = L.moe_apply(lw, x, cfg, no_drop=True)
    parts, outs = [], []
    for r in range(m):
        tp = tensor_parallel(cfg, _SumGroup(r, m))
        assert tp.expert_split == split and tp.shared_split
        assert tp.experts(E) == (slice(r * E // m, (r + 1) * E // m)
                                 if split else slice(0, E))
        lp = layer_params(shard_params(whole, cfg, r, m)["layers"], 0)["moe"]
        assert lp["w_gate"].shape[0] == (E // m if split else E)
        # each rank's term before the all-reduce, and what joins after it
        reduced = []
        tp.reduce = lambda t, reduced=reduced: reduced.append(t) or t
        y, _ = L.moe_apply(lp, x, local_config(cfg, m), no_drop=True, tp=tp)
        assert len(reduced) == 1
        parts.append(reduced[0])
        outs.append(y - reduced[0])
    total = sum(parts)
    for after in outs:
        assert float((total + after - want).abs().max()) < 1e-5


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2-moe-a2.7b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-medium", "mamba2-2.7b"])
def test_weights_drawn_cut_are_the_whole_weights_slices(arch):
    """`init_shard` (each tensor cut as it is drawn) gives every rank
    `shard_params` of the whole init, bit for bit; mamba2's init, which
    transforms drawn tensors, takes the whole-then-cut path."""
    cfg = get_config(arch, "reduced")
    whole = init_params(cfg, 5, torch.float32, "cpu")
    for r in range(2):
        want = dict(named_leaves(shard_params(whole, cfg, r, 2)))
        got = dict(named_leaves(init_shard(cfg, 5, torch.float32, "cpu",
                                           r, 2)))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_vocab_parallel_embedding_and_head_add_up():
    cfg = get_config("granite-3-8b", "reduced")
    m = 2
    embed = torch.randn(cfg.vocab_size, cfg.d_model)
    tokens = torch.tensor([[0, 5, 255, 256, 511]])
    h = torch.randn(1, 5, cfg.d_model)
    emb = head = 0
    for r in range(m):
        tp = TensorParallel(_SumGroup(r, m), local_config(cfg, m),
                            mlp_split=True, vocab_split=True)
        shard = shard_params({"embed": embed}, cfg, r, m)["embed"]
        assert shard.shape[0] == cfg.vocab_size // m
        emb = emb + tp.embed(shard, tokens)
        head = head + tp.gather_vocab(h @ shard.T)
    assert torch.equal(emb, embed[tokens])
    assert float((head - h @ embed.T).abs().max()) == 0.0
