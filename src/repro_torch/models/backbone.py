"""Backbone of the ported families: params, caches and the cached forward
pass (chunked prefill and decode share one path; decode = a chunk of
length 1).

* DENSE: attention + SwiGLU layers (granite-3-8b, starcoder2-7b,
  mistral-nemo-12b, qwen1.5-32b).
* MOE: the same attention layers with the SwiGLU swapped for the GShard
  dense-dispatch MoE (qwen2-moe-a2.7b, kimi-k2-1t-a32b).
* SSM: Mamba2 layers (mamba2-2.7b), no attention and no K/V.
* HYBRID: RG-LRU recurrent layers and local-attention layers in the
  config's block pattern (recurrentgemma-9b).
* VLM: dense self-attention layers with a tanh-gated cross-attention
  layer to the request's image embeddings after every
  num_layers // num_cross_layers of them (llama-3.2-vision-90b).
* ENCDEC: a bidirectional encoder over the request's audio frame
  embeddings, and decoder layers each followed by a cross-attention layer
  to the encoder output (seamless-m4t-medium).

Layer params are stacked on a leading L axis, in the JAX package's nested
layout, so both packages can run the same weights. Attention caches store
absolute positions per slot (-1 = empty); padding tokens carry position -1
and change no visible slot (the write index has one shape per chunk shape:
a padding token writes a slot's own value back, or the paged pools' spare
block). Per-request state (SSM `conv`/`ssm`, RG-LRU
`conv`/`rec`) has one row per cache slot on axis 1, and so do the
cross-attention K/V (`cross_k`/`cross_v`), written only by the call that
carries the request's extras (its first prefill chunk). Caches are updated
in place.

`forward_train` is the training forward over whole sequences, no cache,
as the JAX package's: plain differentiable ops only (`ref.rmsnorm_ref`,
`ref.flash_attention_ref`, the plain SSD and RG-LRU recurrences), unfused
residual adds, and `torch.utils.checkpoint` per layer (per group where the
JAX package checkpoints a group) under `remat`. It never reaches
`kernels.ops`, whose CUDA entries have no backward.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.kernels.ref import rmsnorm_ref
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: the families whose every layer is an attention layer
ATTENTION_ONLY = (ArchFamily.DENSE, ArchFamily.MOE)
#: the families with cross-attention to per-request extras
CROSS_FAMILIES = (ArchFamily.VLM, ArchFamily.ENCDEC)

#: leaves the JAX package keeps in fp32 whatever the working dtype
FP32_LEAVES = frozenset({"A_log", "dt_bias", "D", "lam", "b_a", "b_i",
                         "router"})

#: per-request state of the recurrent families (constant size per request)
STATE_KEYS = ("conv", "ssm", "rec")
#: per-request cross-attention K/V of the VLM and enc-dec families
CROSS_KEYS = ("cross_k", "cross_v")


def cfg_dtype(cfg: ModelConfig, override=None) -> torch.dtype:
    return override if override is not None else DTYPES[cfg.dtype]


def extras_key(cfg: ModelConfig) -> str:
    """The name of a request's extras: audio frames for enc-dec, image
    embeddings for the VLM."""
    return "enc_frames" if cfg.family == ArchFamily.ENCDEC else "images"


def n_cross_layers(cfg: ModelConfig) -> int:
    """Cross-attention layers: one a decoder layer (enc-dec), or
    num_cross_layers (VLM); 0 elsewhere."""
    if cfg.family == ArchFamily.ENCDEC:
        return cfg.num_layers
    return cfg.num_cross_layers if cfg.family == ArchFamily.VLM else 0


def window_of(cfg: ModelConfig) -> int:
    if cfg.attention == AttentionKind.SLIDING:
        return cfg.sliding_window
    if cfg.attention == AttentionKind.LOCAL_HYBRID:
        return cfg.rglru.window_size
    return 0


def phys_cache_len(cfg: ModelConfig, max_context: int, chunk: int = 1) -> int:
    """Ring capacity for windowed attention: a chunk of T queries written
    before attending must still see window-1 keys behind its OLDEST query,
    so the ring holds window + chunk - 1 positions."""
    w = window_of(cfg)
    return min(max_context, w + chunk - 1) if w else max_context


def layer_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(attention layers, recurrent or SSM layers)."""
    kinds = cfg.layer_kinds()
    n_att = sum(1 for k in kinds if k == "attention")
    return n_att, len(kinds) - n_att


# ---------------------------------------------------------------------------
# params


def _dense_layers(init: L.ParamInit, cfg: ModelConfig, n: int,
                  moe: bool = False, cross: bool = False) -> Params:
    """n stacked attention layers, their SwiGLU (`mlp`) or MoE (`moe`);
    `cross`: cross-attention layers (no biases, a `gate` each)."""
    return {"ln1": init.zeros(n, cfg.d_model),
            "ln2": init.zeros(n, cfg.d_model),
            "attn": L.init_attention(init, cfg, n, cross=cross),
            **({"moe": L.init_moe(init, cfg, n)} if moe
               else {"mlp": L.init_mlp(init, cfg, n)})}


def init_params(cfg: ModelConfig, seed: int = 0, dtype=None,
                device="cpu", init: Optional[L.ParamInit] = None) -> Params:
    """Random weights from a seeded torch.Generator with the JAX package's
    scales: normal / sqrt(fan_in), the output projections at
    0.02 / sqrt(2 L), the embedding at 0.02, norms at zero, the MoE
    router at 0.02, the cross-attention gates at zero, and the SSM /
    RG-LRU constants as the JAX package draws them (in fp32). Each weight
    is drawn in place, layer by layer, in the working dtype on `device`,
    so peak memory stays at the weights themselves. The VLM has `layers`
    and `cross_layers`, enc-dec `enc_layers`, `dec_layers` and
    `dec_cross`, as in the JAX package. `init`: the ParamInit to draw
    with (one that cuts each tensor as it is made: `model.init_shard`)."""
    init = init or L.ParamInit(seed, cfg_dtype(cfg, dtype), device)
    d = cfg.d_model
    p: Params = {"embed": init.normal((cfg.vocab_size, d), 0.02),
                 "ln_f": init.zeros(d)}
    if cfg.family in ATTENTION_ONLY:
        p["layers"] = _dense_layers(init, cfg, cfg.num_layers,
                                    moe=cfg.family == ArchFamily.MOE)
    elif cfg.family == ArchFamily.SSM:
        p["layers"] = {"ln1": init.zeros(cfg.num_layers, d),
                       "mixer": S.init_mamba2_block(init, cfg,
                                                    cfg.num_layers)}
    elif cfg.family == ArchFamily.VLM:
        p["layers"] = _dense_layers(init, cfg, cfg.num_layers)
        p["cross_layers"] = _dense_layers(init, cfg, cfg.num_cross_layers,
                                          cross=True)
    elif cfg.family == ArchFamily.ENCDEC:
        p["enc_layers"] = _dense_layers(init, cfg, cfg.encoder_layers)
        p["dec_layers"] = _dense_layers(init, cfg, cfg.num_layers)
        p["dec_cross"] = _dense_layers(init, cfg, cfg.num_layers, cross=True)
    else:
        n_att, n_rec = layer_counts(cfg)
        p["rec_layers"] = {"ln1": init.zeros(n_rec, d),
                           "ln2": init.zeros(n_rec, d),
                           "rec": R.init_rglru_block(init, cfg, n_rec),
                           "mlp": L.init_mlp(init, cfg, n_rec)}
        p["att_layers"] = _dense_layers(init, cfg, n_att)
    if not cfg.tie_embeddings:
        p["lm_head"] = init.normal((d, cfg.vocab_size), 1 / math.sqrt(d))
    return p


def layer_params(stacked: Params, i: int) -> Params:
    """Layer i's params (views) out of the stacked L-axis layout."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def logits_head(p, x, pending, cfg: ModelConfig, tp=None):
    """Logits of the residual stream x plus the last layer's `pending`
    branch output (added inside the final norm). Under tensor parallelism
    (`tp`, a `distributed.sharding.TensorParallel`) a vocab-sharded head's
    logits are gathered, so every rank holds the same full logits."""
    _, h = _norm_in(x, pending, p["ln_f"], cfg)
    wout = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    logits = (h @ wout).float()
    return logits if tp is None else tp.gather_vocab(logits)


# ---------------------------------------------------------------------------
# caches


def _state_cache(cfg: ModelConfig, rows: int, dt, device, m: int = 1
                 ) -> Cache:
    """Per-request state with `rows` rows on axis 1: the conv history in
    the working dtype, the SSM / RG-LRU state in fp32; a rank's on a
    model axis of m (mamba2: its d_inner/m conv channels beside whole B
    and C, its H/m heads' state; the RG-LRU: its w/m channels)."""
    if cfg.family == ArchFamily.SSM:
        d_in, H, P, N = S.ssm_dims(cfg, m)
        L_ = cfg.num_layers
        return {"conv": torch.zeros((L_, rows, cfg.ssm.conv_width - 1,
                                     d_in + 2 * N), dtype=dt, device=device),
                "ssm": torch.zeros((L_, rows, H, P, N), dtype=torch.float32,
                                   device=device)}
    if cfg.family == ArchFamily.HYBRID:
        _, n_rec = layer_counts(cfg)
        w = (cfg.rglru.lru_width or cfg.d_model) // m
        return {"conv": torch.zeros((n_rec, rows, cfg.rglru.conv_width - 1, w),
                                    dtype=dt, device=device),
                "rec": torch.zeros((n_rec, rows, w), dtype=torch.float32,
                                   device=device)}
    return {}


def _cross_cache(cfg: ModelConfig, rows: int, enc_len: int, dt,
                 device, hd: int) -> Cache:
    """Cross-attention K/V with `rows` rows on axis 1: (n_cross, rows,
    enc_len, KV, hd) (hd/m under the head_dim fallback), in the working
    dtype."""
    n = n_cross_layers(cfg)
    if not n:
        return {}
    shape = (n, rows, enc_len, cfg.num_kv_heads, hd)
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k in CROSS_KEYS}


def _tp_dims(cfg: ModelConfig, tp) -> Tuple[int, int]:
    """(model axis, the head_dim the K/V cache stores) under `tp` (a
    `distributed.sharding.TensorParallel`; hd/m under the head_dim
    fallback)."""
    hd = cfg.resolved_head_dim
    return (1, hd) if tp is None else (tp.m, tp.kv_dim(hd))


def init_cache(cfg: ModelConfig, batch: int, max_context: int, dtype=None,
               device="cpu", chunk: int = 1, enc_len: int = 0,
               tp=None, seq_parts: int = 1) -> Cache:
    """Contiguous serving cache: K/V rows (a ring for windowed attention)
    and `pos` for the attention layers, plus the per-request state and the
    cross-attention K/V of `enc_len` keys a row. `tp`: a rank's, its
    state slices and its K/V head_dim (`cfg` its local heads).
    `seq_parts`: the slots are cut over a data axis of that size (a
    sequence-sharded decode, `cache_specs(seq_shard=True)`), and this is
    one data rank's contiguous 1/seq_parts of them."""
    dt = cfg_dtype(cfg, dtype)
    m, kv_hd = _tp_dims(cfg, tp)
    c: Cache = {}
    n_att, _ = layer_counts(cfg)
    if n_att:
        S_ = phys_cache_len(cfg, max_context, chunk)
        if S_ % seq_parts:
            raise ValueError(f"{S_} cache slots do not divide over a data "
                             f"axis of {seq_parts}")
        S_ //= seq_parts
        shape = (n_att, batch, S_, cfg.num_kv_heads, kv_hd)
        c["k"] = torch.zeros(shape, dtype=dt, device=device)
        c["v"] = torch.zeros(shape, dtype=dt, device=device)
        c["pos"] = torch.full((batch, S_), -1, dtype=torch.int32,
                              device=device)
    c.update(_state_cache(cfg, batch, dt, device, m))
    c.update(_cross_cache(cfg, batch, enc_len, dt, device, kv_hd))
    return c


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=None, device="cpu", n_slots: int = 0,
                     enc_len: int = 0, tp=None) -> Cache:
    """Physically paged serving cache (DESIGN §9): K/V in
    (layers, num_blocks + 1, block_size, KV, hd) pools shared by every
    request and indexed through per-request block tables; `pos` is the
    pool-wide (num_blocks + 1, block_size) absolute-position map (-1 =
    empty slot). Block `num_blocks` is the spare: no table names it, and
    padding tokens and tokens of unallocated blocks write there, so the
    write index keeps one shape (`layers.paged_write_index`).

    Per-request state and cross-attention K/V stay per slot, pinned to a
    request for its life: `n_slots` rows plus row `n_slots`, the padding
    sentinel, which reads zeros and is never written
    (`forward_cached(rows=...)`). `tp` as in `init_cache`."""
    dt = cfg_dtype(cfg, dtype)
    m, kv_hd = _tp_dims(cfg, tp)
    c: Cache = {}
    n_att, _ = layer_counts(cfg)
    if n_att:
        shape = (n_att, num_blocks + 1, block_size, cfg.num_kv_heads, kv_hd)
        c["k"] = torch.zeros(shape, dtype=dt, device=device)
        c["v"] = torch.zeros(shape, dtype=dt, device=device)
        c["pos"] = torch.full((num_blocks + 1, block_size), -1,
                              dtype=torch.int32, device=device)
    c.update(_state_cache(cfg, n_slots + 1, dt, device, m))
    c.update(_cross_cache(cfg, n_slots + 1, enc_len, dt, device, kv_hd))
    return c


def cache_bytes(cfg: ModelConfig, batch: int, max_context: int,
                enc_len: int = 0) -> int:
    """Bytes of a contiguous cache, from its shapes (no allocation)."""
    c = init_cache(cfg, batch, max_context, device="meta", enc_len=enc_len)
    return sum(v.numel() * v.element_size() for v in c.values())


# ---------------------------------------------------------------------------
# PREFILL / DECODE (unified chunked step; decode = chunk of length 1)


def _write_index(positions, cache: Cache, tables, tp=None,
                 seq_shard: bool = False) -> L.WriteIndex:
    """Every attention layer writes the same slots, so the write index and
    the `pos` update are computed once, before the layer loop; each layer
    then writes its K/V in place and attends over a cache that already
    holds this chunk (as the JAX package does). `seq_shard`: the cache is
    this data rank of `tp`'s group's slots of a sequence-sharded one
    (`layers.seq_write_index`)."""
    if tables is None:
        S = cache["k"].shape[2]
        widx = L.cache_write_index(positions, S) if not seq_shard \
            else L.seq_write_index(positions, S, tp.group.data_rank,
                                   tp.group.data_size)
        L.cache_put(cache["pos"], widx, positions)
    else:
        # the pools' last block is the spare that takes invisible writes
        index = L.mixed_write_index if isinstance(tables, L.MixedRows) \
            else L.paged_write_index
        widx = index(positions, tables, cache["k"].shape[2],
                     spare=cache["k"].shape[1] - 1)
        flat, real = widx
        cache["pos"].view(-1)[flat] = torch.where(real, positions, -1).to(
            cache["pos"].dtype)
    return widx


def _norm_in(x, pending, w, cfg: ModelConfig):
    """(x + pending, its RMSNorm): the residual add of the previous branch
    output fused into the norm that reads it. Only the model's first norm
    has no branch output pending, and takes the plain norm of x."""
    if pending is None:
        return x, L.rms_norm(x, w, cfg.rms_eps)
    return L.add_rms_norm(x, pending, w, cfg.rms_eps)


# Each layer takes the residual stream x and the previous branch output
# not yet added to it (`pending`, None before the first layer), and
# returns both for the next, so that every residual add happens inside the
# norm that reads it: a layer's ln1, its ln2, or the final ln_f.


def _mlp_tp(tp):
    """`tp` where the SwiGLU is cut on d_ff, else None (whole on every
    rank: no all-reduce)."""
    return tp if tp is not None and tp.mlp_split else None


def _attn_layer(lp, x, pending, positions, cache, i, widx, cfg, window,
                tables, tp=None, seq_shard: bool = False):
    """Under tensor parallelism (`tp`) the attention output and a sharded
    SwiGLU's or MoE's are partial sums over the rank's heads, d_ff columns
    or experts, made whole in their down-projections (`layers.down_proj`,
    `layers.moe_sum`), before the fused add + RMSNorm that adds them to
    the residual stream (otherwise a rank would add its own share only).
    `seq_shard`: a sequence-sharded decode (`layers.decode_seq`)."""
    x, h = _norm_in(x, pending, lp["ln1"], cfg)
    if tables is None:
        a = L.self_attention_cached(lp["attn"], h, positions, cache["k"][i],
                                    cache["v"][i], cache["pos"], widx, cfg,
                                    window=window, tp=tp,
                                    seq_shard=seq_shard)
    else:
        a = L.self_attention_paged(lp["attn"], h, positions, cache["k"][i],
                                   cache["v"][i], cache["pos"], tables, widx,
                                   cfg, window=window, tp=tp)
    x, h = L.add_rms_norm(x, a, lp["ln2"], cfg.rms_eps)
    if "moe" in lp:
        # no_drop: serving is chunking-invariant (`layers.moe_apply`)
        y, _ = L.moe_apply(lp["moe"], h, cfg,
                           no_drop=cfg.moe.inference_no_drop, tp=tp)
        return x, y
    return x, L.mlp(lp["mlp"], h, _mlp_tp(tp))


class _State:
    """Layer-wise access to the per-request state of one call (recurrent
    state and cross-attention K/V alike).

    Contiguous layout (`rows` None): the batch rows ARE cache rows, read
    and written in place. Paged layout: batch row b is state slot rows[b];
    a padding row holds the sentinel slot, which reads zeros, and its
    result is dropped (the sentinel's zeros are written back)."""

    def __init__(self, cache: Cache, rows: Optional[torch.Tensor]):
        self.cache, self.rows = cache, rows
        key = next((k for k in STATE_KEYS + CROSS_KEYS if k in cache), None)
        if rows is not None and key is not None:
            self.real = rows < cache[key].shape[1] - 1

    def get(self, key: str, i: int) -> torch.Tensor:
        v = self.cache[key][i]
        return v if self.rows is None else v.index_select(0, self.rows)

    def put(self, key: str, i: int, old, new) -> None:
        if self.rows is None:
            self.cache[key][i].copy_(new)
            return
        keep = self.real.view((-1,) + (1,) * (new.dim() - 1))
        self.cache[key][i].index_copy_(0, self.rows,
                                       torch.where(keep, new, old))


def _ssm_layer(lp, x, pending, cfg, st: _State, i, decode, tp=None):
    """A Mamba2 layer; under `tp` the rank's share of the mixer, its
    output made whole (`ssm.mamba2_block`)."""
    conv0, ssm0 = st.get("conv", i), st.get("ssm", i)
    x, h = _norm_in(x, pending, lp["ln1"], cfg)
    y, (conv1, ssm1) = S.mamba2_block(lp["mixer"], h, cfg, conv_state=conv0,
                                      ssm_state=ssm0, decode=decode, tp=tp)
    st.put("conv", i, conv0, conv1)
    st.put("ssm", i, ssm0, ssm1)
    return x, y


def _rec_layer(lp, x, pending, cfg, st: _State, i, tp=None):
    """An RG-LRU layer and its SwiGLU; under `tp` the rank's channels and
    d_ff columns, both outputs made whole (`rglru.rglru_block`,
    `layers.mlp`)."""
    conv0, rec0 = st.get("conv", i), st.get("rec", i)
    x, h = _norm_in(x, pending, lp["ln1"], cfg)
    y, (conv1, rec1) = R.rglru_block(lp["rec"], h, cfg, conv_state=conv0,
                                     rec_state=rec0, tp=tp)
    st.put("conv", i, conv0, conv1)
    st.put("rec", i, rec0, rec1)
    x, h = L.add_rms_norm(x, y, lp["ln2"], cfg.rms_eps)
    return x, L.mlp(lp["mlp"], h, _mlp_tp(tp))


def encode(p: Params, frames, cfg: ModelConfig, tp=None):
    """The enc-dec family's bidirectional encoder over stub frame
    embeddings (B, S, d), RoPE at positions 0..S-1. As the JAX package's
    `encode`, it has no final norm: it returns the residual stream after
    the last MLP add, which the fused-norm layers leave pending. Under
    tensor parallelism (`tp`) each layer's attention and MLP outputs are
    made whole as the decoder's are, so every rank returns the whole
    encoder output."""
    B, S, _ = frames.shape
    pos = torch.arange(S, dtype=torch.int32, device=frames.device
                       ).expand(B, S)
    x, y = frames, None
    for i in range(cfg.encoder_layers):
        lp = layer_params(p["enc_layers"], i)
        x, h = _norm_in(x, y, lp["ln1"], cfg)
        a = L.encoder_attention(lp["attn"], h, pos, cfg, tp)
        x, h = L.add_rms_norm(x, a, lp["ln2"], cfg.rms_eps)
        y = L.mlp(lp["mlp"], h, _mlp_tp(tp))
    return x + y


def _write_cross(p_cross: Params, src, cfg: ModelConfig,
                 st: _State, tp=None) -> None:
    """Project src (B, S, d), the image embeddings or the encoder output,
    through every cross layer's wk / wv into the batch rows' cross K/V (a
    paged padding row's sentinel slot is left as it is); under `tp` the
    rank's share (`layers.cross_kv`)."""
    for j in range(n_cross_layers(cfg)):
        k, v = L.cross_kv(layer_params(p_cross, j)["attn"], src, cfg, tp)
        for key, val in zip(CROSS_KEYS, (k, v)):
            st.put(key, j, st.get(key, j) if st.rows is not None else None,
                   val)


def _cross_layer(lp, x, pending, cache, j, cfg, rows, kpos, tp=None):
    """A cross-attention layer (the VLM's tanh-gated, enc-dec's not) and
    its MLP, reading layer j's cross K/V of the batch rows (a rank's
    kv-heads under `tp`; its `wo` and MLP outputs made whole as
    `_attn_layer`'s are)."""
    x, h = _norm_in(x, pending, lp["ln1"], cfg)
    a = L.cross_attention(lp["attn"], h, cache["cross_k"][j],
                          cache["cross_v"][j], cfg,
                          gated=cfg.family == ArchFamily.VLM, rows=rows,
                          kpos=kpos, tp=tp)
    x, h = L.add_rms_norm(x, a, lp["ln2"], cfg.rms_eps)
    return x, L.mlp(lp["mlp"], h, _mlp_tp(tp))


def forward_cached(p: Params, tokens, positions, cache: Cache,
                   cfg: ModelConfig, *, decode: bool = False,
                   last_only: bool = False,
                   tables: Optional[torch.Tensor] = None,
                   rows: Optional[torch.Tensor] = None,
                   extras: Optional[Dict[str, torch.Tensor]] = None,
                   tp=None, seq_shard: bool = False
                   ) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B, T); positions: (B, T) absolute, -1 for padding.

    Returns (logits (B, T, V) fp32, cache), the cache updated in place.
    decode: the SSM / RG-LRU layers take their O(1) step (T == 1).
    last_only: the vocab projection of the final position only.
    tables: optional (B, MB) per-request physical block tables; with them
    the cache is the paged pools of `init_paged_cache` (DESIGN §9), and
    `rows` (B,) names each batch row's state slot (the sentinel slot for a
    padding row) in families with per-request state or cross K/V. A
    `layers.MixedRows` in place of the tables makes a mixed step of the
    attention-only families: tokens and positions (1, N) hold b decode
    rows' tokens and n lane chunks' in one row, the attention splits at b
    (`layers.mixed_attention`), and the logits are (1, b, V), of the
    decode tokens only.
    extras: the VLM's {"images": (B, S, d)} or enc-dec's {"enc_frames":
    (B, S, d)}, given on a request's first chunk only: the images are
    projected (the frames encoded, then projected) into the rows' cross
    K/V, which later calls read. Cast to the working dtype.
    tp: one rank's view of a tensor-parallel group
    (`distributed.sharding.TensorParallel`; every family): `p` holds the
    rank's shards, `cfg` its local heads (`tp.cfg`), the cache its
    kv-heads (the cross K/V too) or under the head_dim fallback hd/m of
    every kv-head, and its share of the per-request state; partial sums
    are all-reduced (`_attn_layer`, `_cross_layer`, `encode`,
    `_ssm_layer`, `_rec_layer`: the self, cross and encoder attention's
    `wo`, the MLPs' `w_down`, the MoE's experts once a layer, mamba2's
    gated-norm sums and `out_proj`, the RG-LRU's `w_out`), the embedding
    and logits made whole.
    seq_shard: a decode on a contiguous cache whose attention slots are
    cut over the data axis of `tp`'s group (`init_cache(seq_parts=...)`):
    each data rank writes the slots it holds and attends over them, and
    the ranks' partial results are combined (`layers.decode_seq`); the
    rest of the step (embedding, projections, recurrent state) every data
    rank runs alike."""
    if decode and tokens.shape[1] != 1:
        raise ValueError("decode takes one token per row")
    if seq_shard and (tp is None or not decode or tables is not None
                      or cfg.family in CROSS_FAMILIES):
        raise ValueError("a sequence-sharded cache takes contiguous decode "
                         "steps of a decoder-only family on a group")
    if tables is not None and rows is None \
            and any(k in cache for k in STATE_KEYS + CROSS_KEYS):
        raise ValueError("the paged cache's per-request state needs `rows`")
    mixed = isinstance(tables, L.MixedRows)
    if mixed and (cfg.family not in ATTENTION_ONLY or tokens.shape[0] != 1):
        raise ValueError("a mixed step takes one row of tokens of an "
                         "attention-only family")
    x = p["embed"][tokens] if tp is None else tp.embed(p["embed"], tokens)
    win = window_of(cfg)
    widx = _write_index(positions, cache, tables, tp, seq_shard) \
        if "k" in cache \
        else None
    st = _State(cache, rows if tables is not None else None)
    y = None  # the branch output pending for the next norm
    if cfg.family in CROSS_FAMILIES:
        crows = st.rows
        kpos = None if crows is None else torch.zeros(
            cache["cross_k"].shape[1:3], dtype=torch.int32, device=x.device)
        src = (extras or {}).get(extras_key(cfg))
        if cfg.family == ArchFamily.VLM:
            if src is not None:
                _write_cross(p["cross_layers"], src.to(x.dtype), cfg, st,
                             tp)
            per = cfg.num_layers // cfg.num_cross_layers
            for i in range(cfg.num_layers):
                x, y = _attn_layer(layer_params(p["layers"], i), x, y,
                                   positions, cache, i, widx, cfg, win,
                                   tables, tp)
                if (i + 1) % per == 0:
                    x, y = _cross_layer(
                        layer_params(p["cross_layers"], i // per), x, y,
                        cache, i // per, cfg, crows, kpos, tp)
        else:
            if src is not None:
                _write_cross(p["dec_cross"],
                             encode(p, src.to(x.dtype), cfg, tp), cfg, st,
                             tp)
            for i in range(cfg.num_layers):
                x, y = _attn_layer(layer_params(p["dec_layers"], i), x, y,
                                   positions, cache, i, widx, cfg, win,
                                   tables, tp)
                x, y = _cross_layer(layer_params(p["dec_cross"], i), x, y,
                                    cache, i, cfg, crows, kpos, tp)
    elif cfg.family in ATTENTION_ONLY:
        for i in range(cfg.num_layers):
            x, y = _attn_layer(layer_params(p["layers"], i), x, y, positions,
                               cache, i, widx, cfg, win, tables, tp,
                               seq_shard)
    elif cfg.family == ArchFamily.SSM:
        for i in range(cfg.num_layers):
            x, y = _ssm_layer(layer_params(p["layers"], i), x, y, cfg, st, i,
                              decode, tp)
    else:
        i_att = i_rec = 0
        for kind in cfg.layer_kinds():
            if kind == "attention":
                x, y = _attn_layer(layer_params(p["att_layers"], i_att), x, y,
                                   positions, cache, i_att, widx, cfg, win,
                                   tables, tp, seq_shard)
                i_att += 1
            else:
                x, y = _rec_layer(layer_params(p["rec_layers"], i_rec), x, y,
                                  cfg, st, i_rec, tp)
                i_rec += 1
    if mixed:
        x, y = x[:, :tables.b], y[:, :tables.b]
    elif last_only:
        x, y = x[:, -1:], y[:, -1:]
    return logits_head(p, x, y, cfg, tp), cache


# ---------------------------------------------------------------------------
# TRAIN forward (full sequence, no cache)


def unstack(stacked: Params) -> List[Params]:
    """The per-layer params of a stacked L-axis layout, every leaf split
    by one `torch.unbind`: its backward stacks the layers' gradients in
    one op, where indexing each layer (`layer_params`) would write every
    layer's gradient into a zero tensor of the whole stack."""
    flat = {k: unstack(v) if isinstance(v, dict) else torch.unbind(v)
            for k, v in stacked.items()}
    n = len(next(iter(flat.values())))
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def _norm(x, w, cfg: ModelConfig):
    return rmsnorm_ref(x, w, eps=cfg.rms_eps)


def _mlp_res(lp, x, cfg: ModelConfig, tp=None):
    return x + L.mlp(lp["mlp"], _norm(x, lp["ln2"], cfg), _mlp_tp(tp))


def _attn_block_train(lp, x, positions, cfg: ModelConfig, window: int,
                      no_drop: bool = False, tp=None):
    """A self-attention layer and its SwiGLU or MoE; returns (x, aux)."""
    h = _norm(x, lp["ln1"], cfg)
    x = x + L.self_attention_train(lp["attn"], h, positions, cfg,
                                   window=window, tp=tp)
    if "moe" in lp:
        y, aux = L.moe_apply(lp["moe"], _norm(x, lp["ln2"], cfg), cfg,
                             no_drop=no_drop, tp=tp)
        return x + y, aux
    return _mlp_res(lp, x, cfg, tp), 0.0


def _cross_block(lp, x, cross_k, cross_v, cfg: ModelConfig, gated: bool,
                 tp=None):
    h = _norm(x, lp["ln1"], cfg)
    x = x + L.cross_attention_train(lp["attn"], h, cross_k, cross_v, cfg,
                                    gated=gated, tp=tp)
    return _mlp_res(lp, x, cfg, tp)


def _ssm_block(lp, x, cfg: ModelConfig, tp=None):
    return x + S.mamba2_block_train(lp["mixer"], _norm(x, lp["ln1"], cfg),
                                    cfg, tp)


def _rec_block(lp, x, cfg: ModelConfig, tp=None):
    x = x + R.rglru_block_train(lp["rec"], _norm(x, lp["ln1"], cfg), cfg,
                                tp)
    return _mlp_res(lp, x, cfg, tp)


def _run(body, remat: bool, *args):
    """body(*args), under a non-reentrant checkpoint when `remat`: its
    activations are dropped after the forward and recomputed in the
    backward."""
    return checkpoint(body, *args, use_reentrant=False) if remat \
        else body(*args)


def forward_train(p: Params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig, *, remat: bool = True,
                  no_drop: bool = False, return_hidden: bool = False,
                  tp=None):
    """batch: {"tokens": (B, T)}, plus {"images": (B, P, d)} (VLM) or
    {"enc_frames": (B, S, d)} (enc-dec), cast to the working dtype.

    Returns (logits (B, T, V) fp32, aux loss), or with return_hidden the
    residual stream (B, T, d) before the final norm in place of the
    logits (the chunked loss never forms (B, T, V)). The MoE dispatches
    with capacity drops unless `no_drop`, as in training.

    tp: one rank's view of a tensor-parallel group, as `forward_cached`'s
    (`p` its shards, `cfg` its local heads): the residual stream is whole
    on every rank, each branch enters the rank's heads, columns, experts
    or channels through `TensorParallel.copy` and leaves through
    `reduce`, so every rank's gradient of a cut leaf is its slice of the
    one-device gradient and of a replicated leaf the whole of it; the
    logits are gathered whole."""
    tokens = batch["tokens"].long()
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device).expand(B, T)
    x = p["embed"][tokens] if tp is None else tp.embed(p["embed"], tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    fam = cfg.family
    if fam in ATTENTION_ONLY:
        win = window_of(cfg)
        for lp in unstack(p["layers"]):
            x, a = _run(lambda h, lp: _attn_block_train(
                lp, h, positions, cfg, win, no_drop, tp), remat, x, lp)
            aux = aux + a
    elif fam == ArchFamily.SSM:
        for lp in unstack(p["layers"]):
            x = _run(lambda h, lp: _ssm_block(lp, h, cfg, tp), remat, x, lp)
    elif fam == ArchFamily.HYBRID:
        x = _hybrid_train(p, x, positions, cfg, remat, tp)
    elif fam == ArchFamily.VLM:
        x, aux = _vlm_train(p, x, positions,
                            batch["images"].to(x.dtype), cfg, remat, tp)
    elif fam == ArchFamily.ENCDEC:
        x, aux = _encdec_train(p, x, positions,
                               batch["enc_frames"].to(x.dtype), cfg, remat,
                               tp)
    else:
        raise ValueError(fam)
    if return_hidden:
        return x, aux
    return logits_head_train(p, x, cfg, tp), aux


def logits_head_train(p: Params, x, cfg: ModelConfig, tp=None):
    """fp32 logits of the residual stream x: the final norm (plain), then
    the tied embedding or the head; under `tp` the rank's vocab columns
    (`logits_shard`) gathered whole."""
    lg = logits_shard(p, x, cfg, tp)
    return lg if tp is None else tp.gather_vocab(lg)


def logits_shard(p: Params, x, cfg: ModelConfig, tp=None):
    """fp32 logits of x over the head's columns this rank holds: all of
    them without `tp` or where the vocab is whole, else the rank's vocab
    shard, the normed x entering it through `copy`."""
    wout = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    h = _norm(x, p["ln_f"], cfg)
    if tp is not None and tp.vocab_split:
        h = tp.copy(h)
    return (h @ wout).float()


def _hybrid_train(p, x, positions, cfg: ModelConfig, remat: bool, tp=None):
    """Whole block-pattern groups, one checkpoint a group, then the
    pattern's remainder unrolled without one, as the JAX package runs
    them."""
    pat = cfg.rglru.block_pattern
    n_groups = cfg.num_layers // len(pat)
    rec, att = unstack(p["rec_layers"]), unstack(p["att_layers"])
    win = cfg.rglru.window_size
    it = {"recurrent": iter(rec), "attention": iter(att)}

    def layer(kind, lp, h):
        if kind == "recurrent":
            return _rec_block(lp, h, cfg, tp)
        return _attn_block_train(lp, h, positions, cfg, win, tp=tp)[0]

    def group(h, lps):
        for kind, lp in zip(pat, lps):
            h = layer(kind, lp, h)
        return h

    for _ in range(n_groups):
        x = _run(group, remat, x, [next(it[k]) for k in pat])
    for kind in cfg.layer_kinds()[n_groups * len(pat):]:
        x = layer(kind, next(it[kind]), x)
    return x


def _vlm_train(p, x, positions, images, cfg: ModelConfig, remat: bool,
               tp=None):
    """A gated cross-attention layer after every num_layers //
    num_cross_layers self layers, one checkpoint a group; the cross K/V
    of the images are projected before the groups, outside them (a
    rank's kv-heads under `tp`)."""
    per = cfg.num_layers // cfg.num_cross_layers
    self_layers = unstack(p["layers"])
    cross = unstack(p["cross_layers"])
    kv = [L.cross_kv(cp["attn"], images, cfg, tp, whole=True)
          for cp in cross]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def group(h, aux, lps, cp, ck, cv):
        for lp in lps:
            h, a = _attn_block_train(lp, h, positions, cfg, 0, tp=tp)
            aux = aux + a
        return _cross_block(cp, h, ck, cv, cfg, gated=True, tp=tp), aux

    for g, cp in enumerate(cross):
        x, aux = _run(group, remat, x, aux,
                      self_layers[g * per:(g + 1) * per], cp, *kv[g])
    return x, aux


def encode_train(p: Params, frames, cfg: ModelConfig, remat: bool = False,
                 tp=None):
    """The enc-dec encoder over frame embeddings (B, S, d) in plain ops:
    bidirectional attention at positions 0..S-1 with RoPE, no final norm,
    one checkpoint a layer under `remat`; `tp` as `forward_train`'s."""
    B, S_, _ = frames.shape
    pos = torch.arange(S_, dtype=torch.int32,
                       device=frames.device).expand(B, S_)

    def body(h, lp):
        h = h + L.self_attention_train(lp["attn"], _norm(h, lp["ln1"], cfg),
                                       pos, cfg, causal=False, tp=tp)
        return _mlp_res(lp, h, cfg, tp)

    x = frames
    for lp in unstack(p["enc_layers"]):
        x = _run(body, remat, x, lp)
    return x


def _encdec_train(p, x, positions, frames, cfg: ModelConfig, remat: bool,
                  tp=None):
    """The encoder, the cross K/V of its output (before the decoder
    layers, outside their checkpoints; under `tp` a rank's kv-heads, the
    output entering them through `copy`), then each decoder layer followed
    by its cross layer, one checkpoint the pair."""
    enc_out = encode_train(p, frames, cfg, remat, tp)
    cross = unstack(p["dec_cross"])
    src = enc_out if tp is None else tp.copy(enc_out)
    kv = [L.cross_kv(cp["attn"], src, cfg, tp, whole=True) for cp in cross]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(h, lp, cp, ck, cv):
        h, a = _attn_block_train(lp, h, positions, cfg, 0, tp=tp)
        return _cross_block(cp, h, ck, cv, cfg, gated=False, tp=tp), a

    for lp, cp, (ck, cv) in zip(unstack(p["dec_layers"]), cross, kv):
        x, a = _run(body, remat, x, lp, cp, ck, cv)
        aux = aux + a
    return x, aux
