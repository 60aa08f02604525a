"""Backbone of the dense family: params, caches and the cached forward pass
(chunked prefill and decode share one path; decode = a chunk of length 1).

Layer params are stacked on a leading L axis, in the JAX package's nested
layout, so both packages can run the same weights. Caches store absolute
positions per slot (-1 = empty); padding tokens carry position -1 and never
write the cache. Caches are updated in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]
Cache = Dict[str, torch.Tensor]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def cfg_dtype(cfg: ModelConfig, override=None) -> torch.dtype:
    return override if override is not None else DTYPES[cfg.dtype]


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family != ArchFamily.DENSE:
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


# ---------------------------------------------------------------------------
# params


def init_params(cfg: ModelConfig, seed: int = 0, dtype=None,
                device="cpu") -> Params:
    """Random weights from a seeded torch.Generator with the JAX package's
    scales: normal / sqrt(fan_in), the output projections at
    0.02 / sqrt(2 L), the embedding at 0.02, norms at zero. Each weight is
    drawn in place, layer by layer, in the working dtype on `device`, so
    peak memory stays at the weights themselves."""
    require_dense(cfg)
    dt = cfg_dtype(cfg, dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    d, f, Ln = cfg.d_model, cfg.d_ff, cfg.num_layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out_scale = 0.02 / math.sqrt(2 * max(Ln, 1))

    def normal(shape, scale):
        return torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, scale, generator=g)

    def stacked(shape, scale=None):
        w = torch.empty((Ln,) + shape, dtype=dt, device=device)
        for i in range(Ln):
            w[i].normal_(0.0, scale if scale is not None
                         else 1 / math.sqrt(shape[0]), generator=g)
        return w

    p: Params = {
        "embed": normal((cfg.vocab_size, d), 0.02),
        "ln_f": torch.zeros(d, dtype=dt, device=device),
        "layers": {
            "ln1": torch.zeros(Ln, d, dtype=dt, device=device),
            "ln2": torch.zeros(Ln, d, dtype=dt, device=device),
            "attn": {"wq": stacked((d, H * hd)), "wk": stacked((d, KV * hd)),
                     "wv": stacked((d, KV * hd)),
                     "wo": stacked((H * hd, d), out_scale)},
            "mlp": {"w_gate": stacked((d, f)), "w_up": stacked((d, f)),
                    "w_down": stacked((f, d), out_scale)},
        },
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p["layers"]["attn"][name] = torch.zeros(Ln, width, dtype=dt,
                                                    device=device)
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((d, cfg.vocab_size), 1 / math.sqrt(d))
    return p


def layer_params(stacked: Params, i: int) -> Params:
    """Layer i's params (views) out of the stacked L-axis layout."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def logits_head(p, x, cfg: ModelConfig):
    h = L.rms_norm(x, p["ln_f"], cfg.rms_eps)
    wout = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return (h @ wout).float()


# ---------------------------------------------------------------------------
# caches


def init_cache(cfg: ModelConfig, batch: int, max_context: int, dtype=None,
               device="cpu", chunk: int = 1) -> Cache:
    require_dense(cfg)
    dt = cfg_dtype(cfg, dtype)
    S = phys_cache_len(cfg, max_context, chunk)
    shape = (cfg.num_layers, batch, S, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.full((batch, S), -1, dtype=torch.int32,
                              device=device)}


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=None, device="cpu") -> Cache:
    """Physically paged serving cache (DESIGN §9): K/V in
    (layers, num_blocks, block_size, KV, hd) pools shared by every request
    and indexed through per-request block tables; `pos` is the pool-wide
    (num_blocks, block_size) absolute-position map (-1 = empty slot)."""
    require_dense(cfg)
    dt = cfg_dtype(cfg, dtype)
    shape = (cfg.num_layers, num_blocks, block_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.full((num_blocks, block_size), -1,
                              dtype=torch.int32, device=device)}


def cache_bytes(cfg: ModelConfig, batch: int, max_context: int,
                enc_len: int = 0) -> int:
    """Bytes of a contiguous dense cache, from its shapes (no allocation)."""
    require_dense(cfg)
    S = phys_cache_len(cfg, max_context)
    kv = 2 * cfg.num_layers * batch * S * cfg.num_kv_heads \
        * cfg.resolved_head_dim
    return kv * torch.finfo(cfg_dtype(cfg)).bits // 8 + batch * S * 4


# ---------------------------------------------------------------------------
# PREFILL / DECODE (unified chunked step; decode = chunk of length 1)


def _attn_block_cached(p, x, positions, ck, cv, cpos, widx, cfg, window):
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    x = x + L.self_attention_cached(p["attn"], h, positions, ck, cv, cpos,
                                    widx, cfg, window=window)
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + L.mlp(p["mlp"], h)


def _attn_block_paged(p, x, positions, ck, cv, cpos, tables, widx, cfg,
                      window):
    h = L.rms_norm(x, p["ln1"], cfg.rms_eps)
    x = x + L.self_attention_paged(p["attn"], h, positions, ck, cv, cpos,
                                   tables, widx, cfg, window=window)
    h = L.rms_norm(x, p["ln2"], cfg.rms_eps)
    return x + L.mlp(p["mlp"], h)


def _attn_stack_cached(stacked, x, positions, cache, cfg, win, tables=None):
    """Layer loop of the cached (serving) path. Every layer writes the same
    slots, so the write index and the `pos` update are computed once, before
    the loop; each layer then writes its K/V in place and attends over a
    cache that already holds this chunk (as the JAX package does)."""
    if tables is None:
        widx = L.cache_write_index(positions, cache["k"].shape[2])
        rows, toks, slots = widx
        cache["pos"][rows, slots] = positions[rows, toks]
    else:
        widx = L.paged_write_index(positions, tables, cache["k"].shape[2])
        rows, toks, flat = widx
        cache["pos"].view(-1)[flat] = positions[rows, toks]
    for i in range(cache["k"].shape[0]):
        lp = layer_params(stacked, i)
        if tables is None:
            x = _attn_block_cached(lp, x, positions, cache["k"][i],
                                   cache["v"][i], cache["pos"], widx, cfg,
                                   win)
        else:
            x = _attn_block_paged(lp, x, positions, cache["k"][i],
                                  cache["v"][i], cache["pos"], tables, widx,
                                  cfg, win)
    return x


def forward_cached(p: Params, tokens, positions, cache: Cache,
                   cfg: ModelConfig, *, last_only: bool = False,
                   tables: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B, T); positions: (B, T) absolute, -1 for padding.

    Returns (logits (B, T, V) fp32, cache), the cache updated in place.
    last_only: the vocab projection of the final position only.
    tables: optional (B, MB) per-request physical block tables; with them
    the cache is the paged pools of `init_paged_cache` (DESIGN §9)."""
    require_dense(cfg)
    x = p["embed"][tokens]
    x = _attn_stack_cached(p["layers"], x, positions, cache, cfg,
                           window_of(cfg), tables=tables)
    if last_only:
        x = x[:, -1:]
    return logits_head(p, x, cfg), cache
