"""Backbone of the ported families: params, caches and the cached forward
pass (chunked prefill and decode share one path; decode = a chunk of
length 1).

* DENSE: attention + SwiGLU layers (granite-3-8b).
* SSM: Mamba2 layers (mamba2-2.7b), no attention and no K/V.
* HYBRID: RG-LRU recurrent layers and local-attention layers in the
  config's block pattern (recurrentgemma-9b).

Layer params are stacked on a leading L axis, in the JAX package's nested
layout, so both packages can run the same weights. Attention caches store
absolute positions per slot (-1 = empty); padding tokens carry position -1
and change no visible slot (the write index has one shape per chunk shape:
a padding token writes a slot's own value back, or the paged pools' spare
block). Per-request state (SSM `conv`/`ssm`, RG-LRU
`conv`/`rec`) has one row per cache slot on axis 1. Caches are updated in
place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

PORTED_FAMILIES = (ArchFamily.DENSE, ArchFamily.SSM, ArchFamily.HYBRID)

#: leaves the JAX package keeps in fp32 whatever the working dtype
FP32_LEAVES = frozenset({"A_log", "dt_bias", "D", "lam", "b_a", "b_i"})

#: per-request state of the recurrent families (constant size per request)
STATE_KEYS = ("conv", "ssm", "rec")


def cfg_dtype(cfg: ModelConfig, override=None) -> torch.dtype:
    return override if override is not None else DTYPES[cfg.dtype]


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family.value!r} is not yet ported to repro_torch")


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


def _dense_layers(init: L.ParamInit, cfg: ModelConfig, n: int) -> Params:
    return {"ln1": init.zeros(n, cfg.d_model),
            "ln2": init.zeros(n, cfg.d_model),
            "attn": L.init_attention(init, cfg, n),
            "mlp": L.init_mlp(init, cfg, n)}


def init_params(cfg: ModelConfig, seed: int = 0, dtype=None,
                device="cpu") -> Params:
    """Random weights from a seeded torch.Generator with the JAX package's
    scales: normal / sqrt(fan_in), the output projections at
    0.02 / sqrt(2 L), the embedding at 0.02, norms at zero, and the SSM /
    RG-LRU constants as the JAX package draws them (in fp32). Each weight
    is drawn in place, layer by layer, in the working dtype on `device`,
    so peak memory stays at the weights themselves."""
    require_ported(cfg)
    init = L.ParamInit(seed, cfg_dtype(cfg, dtype), device)
    d = cfg.d_model
    p: Params = {"embed": init.normal((cfg.vocab_size, d), 0.02),
                 "ln_f": init.zeros(d)}
    if cfg.family == ArchFamily.DENSE:
        p["layers"] = _dense_layers(init, cfg, cfg.num_layers)
    elif cfg.family == ArchFamily.SSM:
        p["layers"] = {"ln1": init.zeros(cfg.num_layers, d),
                       "mixer": S.init_mamba2_block(init, cfg,
                                                    cfg.num_layers)}
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


def logits_head(p, x, pending, cfg: ModelConfig):
    """Logits of the residual stream x plus the last layer's `pending`
    branch output (added inside the final norm)."""
    _, h = _norm_in(x, pending, p["ln_f"], cfg)
    wout = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return (h @ wout).float()


# ---------------------------------------------------------------------------
# caches


def _state_cache(cfg: ModelConfig, rows: int, dt, device) -> Cache:
    """Per-request state with `rows` rows on axis 1: the conv history in
    the working dtype, the SSM / RG-LRU state in fp32."""
    if cfg.family == ArchFamily.SSM:
        d_in, H, P, N = S.ssm_dims(cfg)
        L_ = cfg.num_layers
        return {"conv": torch.zeros((L_, rows, cfg.ssm.conv_width - 1,
                                     d_in + 2 * N), dtype=dt, device=device),
                "ssm": torch.zeros((L_, rows, H, P, N), dtype=torch.float32,
                                   device=device)}
    if cfg.family == ArchFamily.HYBRID:
        _, n_rec = layer_counts(cfg)
        w = cfg.rglru.lru_width or cfg.d_model
        return {"conv": torch.zeros((n_rec, rows, cfg.rglru.conv_width - 1, w),
                                    dtype=dt, device=device),
                "rec": torch.zeros((n_rec, rows, w), dtype=torch.float32,
                                   device=device)}
    return {}


def init_cache(cfg: ModelConfig, batch: int, max_context: int, dtype=None,
               device="cpu", chunk: int = 1) -> Cache:
    """Contiguous serving cache: K/V rows (a ring for windowed attention)
    and `pos` for the attention layers, plus the per-request state."""
    require_ported(cfg)
    dt = cfg_dtype(cfg, dtype)
    c: Cache = {}
    n_att, _ = layer_counts(cfg)
    if n_att:
        S_ = phys_cache_len(cfg, max_context, chunk)
        shape = (n_att, batch, S_, cfg.num_kv_heads, cfg.resolved_head_dim)
        c["k"] = torch.zeros(shape, dtype=dt, device=device)
        c["v"] = torch.zeros(shape, dtype=dt, device=device)
        c["pos"] = torch.full((batch, S_), -1, dtype=torch.int32,
                              device=device)
    c.update(_state_cache(cfg, batch, dt, device))
    return c


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=None, device="cpu", n_slots: int = 0) -> Cache:
    """Physically paged serving cache (DESIGN §9): K/V in
    (layers, num_blocks + 1, block_size, KV, hd) pools shared by every
    request and indexed through per-request block tables; `pos` is the
    pool-wide (num_blocks + 1, block_size) absolute-position map (-1 =
    empty slot). Block `num_blocks` is the spare: no table names it, and
    padding tokens and tokens of unallocated blocks write there, so the
    write index keeps one shape (`layers.paged_write_index`).

    Per-request state stays per slot, pinned to a request for its life:
    `n_slots` rows plus row `n_slots`, the padding sentinel, which reads
    zeros and is never written (`forward_cached(rows=...)`)."""
    require_ported(cfg)
    dt = cfg_dtype(cfg, dtype)
    c: Cache = {}
    n_att, _ = layer_counts(cfg)
    if n_att:
        shape = (n_att, num_blocks + 1, block_size, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        c["k"] = torch.zeros(shape, dtype=dt, device=device)
        c["v"] = torch.zeros(shape, dtype=dt, device=device)
        c["pos"] = torch.full((num_blocks + 1, block_size), -1,
                              dtype=torch.int32, device=device)
    c.update(_state_cache(cfg, n_slots + 1, dt, device))
    return c


def cache_bytes(cfg: ModelConfig, batch: int, max_context: int) -> int:
    """Bytes of a contiguous cache, from its shapes (no allocation)."""
    c = init_cache(cfg, batch, max_context, device="meta")
    return sum(v.numel() * v.element_size() for v in c.values())


# ---------------------------------------------------------------------------
# PREFILL / DECODE (unified chunked step; decode = chunk of length 1)


def _write_index(positions, cache: Cache, tables) -> L.WriteIndex:
    """Every attention layer writes the same slots, so the write index and
    the `pos` update are computed once, before the layer loop; each layer
    then writes its K/V in place and attends over a cache that already
    holds this chunk (as the JAX package does)."""
    if tables is None:
        widx = L.cache_write_index(positions, cache["k"].shape[2])
        L.cache_put(cache["pos"], widx, positions)
    else:
        # the pools' last block is the spare that takes invisible writes
        widx = L.paged_write_index(positions, tables, cache["k"].shape[2],
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


def _attn_layer(lp, x, pending, positions, cache, i, widx, cfg, window,
                tables):
    x, h = _norm_in(x, pending, lp["ln1"], cfg)
    if tables is None:
        a = L.self_attention_cached(lp["attn"], h, positions, cache["k"][i],
                                    cache["v"][i], cache["pos"], widx, cfg,
                                    window=window)
    else:
        a = L.self_attention_paged(lp["attn"], h, positions, cache["k"][i],
                                   cache["v"][i], cache["pos"], tables, widx,
                                   cfg, window=window)
    x, h = L.add_rms_norm(x, a, lp["ln2"], cfg.rms_eps)
    return x, L.mlp(lp["mlp"], h)


class _State:
    """Layer-wise access to the per-request state of one call.

    Contiguous layout (`rows` None): the batch rows ARE cache rows, read
    and written in place. Paged layout: batch row b is state slot rows[b];
    a padding row holds the sentinel slot, which reads zeros, and its
    result is dropped (the sentinel's zeros are written back)."""

    def __init__(self, cache: Cache, rows: Optional[torch.Tensor]):
        self.cache, self.rows = cache, rows
        key = next((k for k in STATE_KEYS if k in cache), None)
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


def _ssm_layer(lp, x, pending, cfg, st: _State, i, decode):
    conv0, ssm0 = st.get("conv", i), st.get("ssm", i)
    x, h = _norm_in(x, pending, lp["ln1"], cfg)
    y, (conv1, ssm1) = S.mamba2_block(lp["mixer"], h, cfg, conv_state=conv0,
                                      ssm_state=ssm0, decode=decode)
    st.put("conv", i, conv0, conv1)
    st.put("ssm", i, ssm0, ssm1)
    return x, y


def _rec_layer(lp, x, pending, cfg, st: _State, i):
    conv0, rec0 = st.get("conv", i), st.get("rec", i)
    x, h = _norm_in(x, pending, lp["ln1"], cfg)
    y, (conv1, rec1) = R.rglru_block(lp["rec"], h, cfg, conv_state=conv0,
                                     rec_state=rec0)
    st.put("conv", i, conv0, conv1)
    st.put("rec", i, rec0, rec1)
    x, h = L.add_rms_norm(x, y, lp["ln2"], cfg.rms_eps)
    return x, L.mlp(lp["mlp"], h)


def forward_cached(p: Params, tokens, positions, cache: Cache,
                   cfg: ModelConfig, *, decode: bool = False,
                   last_only: bool = False,
                   tables: Optional[torch.Tensor] = None,
                   rows: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B, T); positions: (B, T) absolute, -1 for padding.

    Returns (logits (B, T, V) fp32, cache), the cache updated in place.
    decode: the SSM / RG-LRU layers take their O(1) step (T == 1).
    last_only: the vocab projection of the final position only.
    tables: optional (B, MB) per-request physical block tables; with them
    the cache is the paged pools of `init_paged_cache` (DESIGN §9), and
    `rows` (B,) names each batch row's state slot (the sentinel slot for a
    padding row) in families with per-request state."""
    require_ported(cfg)
    if decode and tokens.shape[1] != 1:
        raise ValueError("decode takes one token per row")
    if tables is not None and rows is None \
            and any(k in cache for k in STATE_KEYS):
        raise ValueError("the paged cache's per-request state needs `rows`")
    x = p["embed"][tokens]
    win = window_of(cfg)
    widx = _write_index(positions, cache, tables) if "k" in cache else None
    st = _State(cache, rows if tables is not None else None)
    y = None  # the branch output pending for the next norm
    if cfg.family == ArchFamily.DENSE:
        for i in range(cfg.num_layers):
            x, y = _attn_layer(layer_params(p["layers"], i), x, y, positions,
                               cache, i, widx, cfg, win, tables)
    elif cfg.family == ArchFamily.SSM:
        for i in range(cfg.num_layers):
            x, y = _ssm_layer(layer_params(p["layers"], i), x, y, cfg, st, i,
                              decode)
    else:
        i_att = i_rec = 0
        for kind in cfg.layer_kinds():
            if kind == "attention":
                x, y = _attn_layer(layer_params(p["att_layers"], i_att), x, y,
                                   positions, cache, i_att, widx, cfg, win,
                                   tables)
                i_att += 1
            else:
                x, y = _rec_layer(layer_params(p["rec_layers"], i_rec), x, y,
                                  cfg, st, i_rec)
                i_rec += 1
    if last_only:
        x, y = x[:, -1:], y[:, -1:]
    return logits_head(p, x, y, cfg), cache
