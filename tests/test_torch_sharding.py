"""The port's serving shardings (`repro_torch.distributed.sharding`)
against the JAX package's rules, and the arithmetic of a rank's shard.

* The DESIGN §5 name table and the divisibility check, leaf for leaf
  against `repro.distributed.sharding._spec_for` and `_validate` on a
  fake mesh (as tests/test_sharding.py calls `_validate`), for every
  param leaf of all ten archs, reduced and full (the port's params built
  on the meta device), at model axes 2, 4 and 16; the serving specs as
  `serve_param_shardings` strips them.
* The starcoder2 36-heads case, and which layouts the port serves: the
  head_dim fallback for self-attention K/V, not yet for cross K/V.
* Each rank's slices, put back together, are the whole params (mamba2's
  `in_proj` and `conv_*` by their segments: a rank's z, x and dt columns
  and x conv channels, B and C whole).
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
* The SSM and hybrid families at m simulated ranks (threads whose group
  sums and gathers for real): a mamba2 block (the split gated norm) and
  an RG-LRU block (the gathered x), prefill and decode, give the whole
  block's output on every rank and the slices of its state; the split
  norm's plain version is the whole row's norm; under the head_dim
  fallback the ranks' caches, gathered, are the one-device cache.
"""
import threading

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.config.registry import get_config as jax_config
from repro.distributed.sharding import _spec_for, _validate
from repro.distributed.sharding import kv_head_axes as jax_kv_head_axes

from repro_torch.config.registry import get_config, list_archs
from repro_torch.core.memory_model import kv_shard_factor
from repro_torch.distributed.sharding import (ServingGroup, TensorParallel,
                                              check_tp, head_span,
                                              kv_head_axes, local_config,
                                              q_gathered, segments,
                                              serve_spec, shard_params,
                                              spec_for, tensor_parallel,
                                              validate)
from repro_torch.kernels import ref
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SM
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


def _port_serves(cfg, m) -> bool:
    """The layouts the port serves, written out: the SSD heads and the
    RG-LRU channels divide the axis, and the kv-heads or head_dim do (the
    query heads may split: a rank's span of them, `head_span`)."""
    if cfg.family.value == "ssm":
        return SM.ssm_dims(cfg)[1] % m == 0
    if cfg.family.value == "hybrid" and cfg.rglru.lru_width % m:
        return False
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return not (KV % m and hd % m)


@pytest.mark.parametrize("arch", list_archs())
def test_cache_axes_and_per_rank_cache_shapes(arch):
    """The cache rule (`kv_head_axes`) is the JAX package's, and agrees
    with the pool's shard count (`kv_shard_factor`); where the port serves
    a mesh, a rank's caches hold KV/m heads at the same head_dim, or under
    the head_dim fallback all KV heads at hd/m (`serve_cache_shardings`'
    shards), and its share of the per-request state: mamba2's d_inner/m
    conv channels beside whole B and C and its H/m heads' state, the
    RG-LRU's w/m channels; elsewhere `check_tp` raises."""
    for variant in ("reduced", "full"):
        cfg = get_config(arch, variant)
        KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        for m in MODEL_AXES:
            axes = kv_head_axes(m, KV, hd)
            assert axes == tuple(jax_kv_head_axes(FakeMesh(m), KV, hd))
            if cfg.kv_bytes_per_token():
                assert kv_shard_factor(cfg, m) \
                    == (m if axes != (None, None) else 1)
            if not _port_serves(cfg, m):
                with pytest.raises(NotImplementedError):
                    check_tp(cfg, m)
                continue
            tp = tensor_parallel(cfg, _SumGroup(0, m))
            assert tp.hd_split == (axes[0] is None)
            want_kv = (KV, hd // m) if tp.hd_split else (KV // m, hd)
            for c in (init_cache(tp.cfg, 2, 32, device="meta", enc_len=5,
                                 tp=tp),
                      init_paged_cache(tp.cfg, 4, 16, device="meta",
                                       enc_len=5, tp=tp)):
                if KV:
                    assert c["k"].shape[-2:] == want_kv
                    assert c["k"].shape[0] == sum(
                        k == "attention" for k in cfg.layer_kinds())
                if "cross_k" in c:
                    assert c["cross_k"].shape[-3:] == (5,) + want_kv
                if cfg.family.value == "ssm":
                    d_in, H, P, N = SM.ssm_dims(cfg)
                    assert c["conv"].shape[-1] == d_in // m + 2 * N
                    assert c["ssm"].shape[-3:] == (H // m, P, N)
                if cfg.family.value == "hybrid":
                    w = cfg.rglru.lru_width
                    assert c["conv"].shape[-1] == c["rec"].shape[-1] \
                        == w // m


def test_starcoder2_36_heads_do_not_divide_16():
    """36 heads on a 16-way model axis do not shard as whole heads (the JAX
    file's case): `validate` keeps the flat 36·128 cut of `wq`, and the
    port serves starcoder2 at 8 and 16 as the JAX package does, its 4
    kv-heads on the head_dim fallback and each rank's attention on a span
    of whole heads around its columns, q gathered (`head_span`,
    `q_gathered`); at 4 a rank holds 9 whole heads. What is still
    refused: a model axis neither the kv-heads nor head_dim divide."""
    sizes = {"data": 16, "model": 16}
    assert validate((None, "model"), (10, 36), sizes) == (None, None)
    assert validate((None, "model"), (10, 64), sizes) == (None, "model")
    cfg = get_config("starcoder2-7b", "full")
    assert cfg.num_heads == 36
    for m in (8, 16):
        check_tp(cfg, m)
        assert serve_spec("layers/attn/wq", (32, 4608, 4608), cfg, m) \
            == (None, None, "model")
        spans = [head_span(cfg, m, r) for r in range(m)]
        assert spans[0][0] == 0 and spans[-1][1] == 36
        assert local_config(cfg, m, 1).num_heads == spans[1][1] - spans[1][0]
        assert q_gathered(cfg, m)
    assert local_config(cfg, 4).num_heads == 9 and not q_gathered(cfg, 4)
    with pytest.raises(NotImplementedError, match="neither its 4 kv-heads "
                                                  "nor head_dim 128"):
        check_tp(cfg, 3)


def _reassemble(name, parts, cfg, m, axis):
    """The whole leaf from its m ranks' slices: along `axis`, or, for a
    leaf cut by segment, each cut segment's slices in rank order and each
    whole one (the same on every rank) once."""
    segs = segments(name, cfg)
    if segs is None:
        return torch.cat(parts, axis)
    out, at = [], 0
    for width, cut in segs:
        n = width // m if cut else width
        pieces = [p.narrow(-1, at, n) for p in parts]
        if cut:
            out.append(torch.cat(pieces, -1))
        else:
            assert all(torch.equal(x, pieces[0]) for x in pieces)
            out.append(pieces[0])
        at += n
    assert at == parts[0].shape[-1]
    return torch.cat(out, -1)


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
        if "model" in spec or segments(name, cfg):
            split += 1
            axis = spec.index("model") if "model" in spec else -1
            assert torch.equal(_reassemble(name, parts, cfg, m, axis), w), \
                name
        else:
            assert all(p is w for p in parts), name
    assert split > 0


def test_mamba2_segment_cut_at_full_width():
    """mamba2-2.7b at m = 2: a rank's `in_proj` holds 5416 of the 10576
    columns (its 2560 of z and of x, B and C's 128 each, its 40 of the 80
    dt heads; the §5 rule's flat cut would give rank 0 all of z and 168
    columns of x), its conv 2560 + 256 of 5376 channels, its `norm_w`
    2560 and its `out_proj` 2560 rows; dt_bias, A_log and D stay whole."""
    cfg = get_config("mamba2-2.7b", "full")
    whole = dict(named_leaves(init_params(cfg, device="meta")))
    mine = dict(named_leaves(shard_params(
        init_params(cfg, device="meta"), cfg, 1, 2)))
    assert whole["layers/mixer/in_proj"].shape[-1] == 10576
    assert mine["layers/mixer/in_proj"].shape[-1] == 5416
    assert mine["layers/mixer/conv_w"].shape[-1] == 2816
    assert mine["layers/mixer/conv_b"].shape[-1] == 2816
    assert mine["layers/mixer/norm_w"].shape[-1] == 2560
    assert mine["layers/mixer/out_proj"].shape[-2] == 2560
    for k in ("dt_bias", "A_log", "D"):
        assert mine[f"layers/mixer/{k}"].shape[-1] == 80


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
                                  "seamless-m4t-medium", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
def test_weights_drawn_cut_are_the_whole_weights_slices(arch):
    """`init_shard` (each tensor cut as it is drawn) gives every rank
    `shard_params` of the whole init, bit for bit: mamba2's segment-cut
    mixer and its transformed dt_bias, and RecurrentGemma's lam, are cut
    as they are made too."""
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


# -- the SSM and hybrid families at m simulated ranks -------------------------


class _Hub:
    """m threads' meeting point: each hands in its tensor and gets every
    rank's back, in rank order."""

    def __init__(self, m):
        self.slots, self.wall = [None] * m, threading.Barrier(m, timeout=60)

    def swap(self, rank, x):
        self.slots[rank] = x
        self.wall.wait()
        got = list(self.slots)
        self.wall.wait()
        return got


class _ThreadRank(ServingGroup):
    """One simulated rank of a (1, m) group, run in a thread: its
    all-reduce sums the ranks' tensors in rank order, its gather
    concatenates their slices along the last axis."""

    def __init__(self, hub, rank, m):
        super().__init__((1, m), rank, m, "gloo", None, None)
        self.hub = hub

    def all_reduce(self, x):
        parts = self.hub.swap(self.rank, x.clone())
        return x.copy_(sum(parts[1:], parts[0]))

    def gather(self, x):
        return torch.cat(self.hub.swap(self.rank, x), -1)


def _on_ranks(m, fn):
    """fn(rank, group) in m threads of one simulated group; the results in
    rank order (a thread's exception is raised here)."""
    hub, out = _Hub(m), [None] * m

    def run(r):
        try:
            out[r] = fn(r, _ThreadRank(hub, r, m))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out[r] = e
            hub.wall.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(m)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for o in out:
        if isinstance(o, BaseException):
            raise o
    return out


def _numpy_weights(cfg, seed=0):
    """The whole weights with every leaf drawn with numpy (non-zero norms,
    biases and conv biases)."""
    rng = np.random.RandomState(seed)
    whole = init_params(cfg, 0, torch.float32, "cpu")
    for name, t in named_leaves(whole):
        if name.endswith(("A_log", "lam")):
            continue            # the decays stay as the init draws them
        scale = 0.1 if t.dim() <= 2 else 1 / np.sqrt(t.shape[-2])
        t.copy_(torch.from_numpy(
            (rng.standard_normal(t.shape) * scale).astype(np.float32)))
    return whole


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_rank_blocks_sum_to_the_whole_block(arch, m):
    """A mamba2 block and an RG-LRU block at m simulated ranks (a prefill
    of 7 tokens from zero state, then a decode step, on each rank's params
    and state slices): the group sums the ranks' partial `out_proj` /
    `w_out` products (and mamba2's gated-norm sums of squares), and every
    rank's output is the whole block's within 1e-5; each rank's state is
    its slice of the whole block's (mamba2: its x conv channels beside
    whole B and C, its heads' SSM state; the RG-LRU: its channels)."""
    cfg = get_config(arch, "reduced")
    whole = _numpy_weights(cfg)
    rng = np.random.RandomState(1)
    u = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model))
                         .astype(np.float32))
    ssm = arch.startswith("mamba2")
    key = "layers" if ssm else "rec_layers"

    def block(p, x, tp, state):
        if ssm:
            conv, h = state
            return SM.mamba2_block(p["mixer"], x, cfg, conv_state=conv,
                                   ssm_state=h, decode=x.shape[1] == 1,
                                   tp=tp)
        conv, h = state
        return RG.rglru_block(p["rec"], x, cfg, conv_state=conv,
                              rec_state=h, tp=tp)

    def steps(p, tp):
        y1, st = block(p, u[:, :7], tp, (None, None))
        y2, st = block(p, u[:, 7:], tp, st)
        return torch.cat([y1, y2], 1), st

    want, (conv_w, h_w) = steps(layer_params(whole[key], 0), None)

    def rank(r, group):
        tp = tensor_parallel(cfg, group)
        return steps(layer_params(shard_params(whole, cfg, r, m)[key], 0),
                     tp)

    outs = _on_ranks(m, rank)
    for r, (y, (conv, h)) in enumerate(outs):
        assert float((y - want).abs().max()) < 1e-5, r
        if ssm:
            d_in, H, _, N = SM.ssm_dims(cfg)
            k = d_in // m
            assert torch.allclose(conv[..., :k],
                                  conv_w[..., r * k:(r + 1) * k], atol=1e-6)
            assert torch.allclose(conv[..., k:], conv_w[..., d_in:],
                                  atol=1e-6)
            hh = H // m
            assert torch.allclose(h, h_w[:, r * hh:(r + 1) * hh], atol=1e-5)
        else:
            k = cfg.rglru.lru_width // m
            assert torch.allclose(conv, conv_w[..., r * k:(r + 1) * k],
                                  atol=1e-6)
            assert torch.allclose(h, h_w[:, r * k:(r + 1) * k], atol=1e-5)


def test_split_norm_plain_version_is_the_whole_rows_norm():
    """`ref.rmsnorm_split_ref` on m ranks' slices of a row, their sums of
    squares added over the ranks, is `rmsnorm_ref` of the whole row's
    slices within 1e-6 (in bf16 within a bf16 step); with no reduce it is
    `rmsnorm_ref` bit for bit."""
    g = torch.Generator().manual_seed(0)
    d, m = 256, 4
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
        x = (torch.randn(3, 5, d, generator=g) * 3).to(dtype)
        w = (torch.randn(d, generator=g) * 0.1).to(dtype)
        want = ref.rmsnorm_ref(x, w, eps=1e-5)
        assert torch.equal(ref.rmsnorm_split_ref(x, w, d=d, eps=1e-5), want)
        k = d // m
        sums = [(x[..., r * k:(r + 1) * k].float() ** 2).sum(-1)
                for r in range(m)]
        total = sum(sums[1:], sums[0])
        got = torch.cat([ref.rmsnorm_split_ref(
            x[..., r * k:(r + 1) * k], w[r * k:(r + 1) * k], d=d, eps=1e-5,
            reduce=lambda s: total) for r in range(m)], -1)
        assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("arch,m", [("recurrentgemma-9b", 2),
                                    ("recurrentgemma-9b", 4),
                                    ("granite-3-8b", 4)])
def test_fallback_kv_gathered_from_the_ranks_equals_one_device(arch, m,
                                                               paged):
    """Under the head_dim fallback (the hybrid's single kv-head, reduced
    granite's 2 at m = 4) each rank's cache holds hd/m of every kv-head;
    after a chunk of 6 tokens and a decode step, the ranks' caches
    concatenated on head_dim are the one-device cache within 1e-6, and
    every rank's attention output (its heads' partial `wo` products summed
    by the group) is the whole layer's within 1e-5."""
    cfg = get_config(arch, "reduced")
    whole = _numpy_weights(cfg)
    key = "att_layers" if cfg.family.value == "hybrid" else "layers"
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.standard_normal((2, 7, cfg.d_model))
                         .astype(np.float32))
    pos = torch.arange(7, dtype=torch.int32).expand(2, 7) + 3
    S, bs = 16, 4

    def attend(lp, c, tp):
        hd = tp.kv_dim(c.resolved_head_dim) if tp else c.resolved_head_dim
        outs = []
        if paged:
            k = torch.zeros(2 * S // bs + 1, bs, c.num_kv_heads, hd)
            v = torch.zeros_like(k)
            kpos = torch.full(k.shape[:2], -1, dtype=torch.int32)
            tables = torch.arange(2 * S // bs, dtype=torch.int32).view(2, -1)
            for sl in (slice(0, 6), slice(6, 7)):
                widx = L.paged_write_index(pos[:, sl], tables, bs,
                                           spare=k.shape[0] - 1)
                kpos.view(-1)[widx[0]] = pos[:, sl]
                outs.append(L.self_attention_paged(
                    lp["attn"], x[:, sl], pos[:, sl], k, v, kpos, tables,
                    widx, c, tp=tp))
        else:
            k = torch.zeros(2, S, c.num_kv_heads, hd)
            v = torch.zeros_like(k)
            kpos = torch.full((2, S), -1, dtype=torch.int32)
            for sl in (slice(0, 6), slice(6, 7)):
                widx = L.cache_write_index(pos[:, sl], S)
                L.cache_put(kpos, widx, pos[:, sl])
                outs.append(L.self_attention_cached(
                    lp["attn"], x[:, sl], pos[:, sl], k, v, kpos, widx, c,
                    tp=tp))
        return torch.cat(outs, 1), k, v

    want, k_w, v_w = attend(layer_params(whole[key], 0), cfg, None)

    def rank(r, group):
        tp = tensor_parallel(cfg, group)
        assert tp.hd_split
        return attend(layer_params(shard_params(whole, cfg, r, m)[key], 0),
                      tp.cfg, tp)

    outs = _on_ranks(m, rank)
    for got, _, _ in outs:
        assert float((got - want).abs().max()) < 1e-5
    for mine, ref_kv in ((1, k_w), (2, v_w)):
        cat = torch.cat([o[mine] for o in outs], -1)
        assert cat.shape == ref_kv.shape
        assert float((cat - ref_kv).abs().max()) < 1e-6
