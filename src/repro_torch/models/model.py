"""Public model facade: an `nn.Module` over the plain functions of
`backbone`, bound to one ModelConfig, one device and one dtype.

Params are a plain nested dict of tensors (the JAX package's layout), made
by `init` or converted by `params.from_jax_params`, and passed to each call
as in the JAX facade. The entry points run on the card unless the caller
asks for the CPU: `device` defaults to "cuda", and a missing GPU raises.
Serving (`forward` and the calls over it) runs without autograd; training
(`forward_train`, `loss_fn`) takes params that are leaves requiring grad
(`training.train_loop.trainable`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import ArchFamily, ModelConfig
from repro_torch.models import backbone as B

# stub-frontend lengths (the modality encoders are stubs), as in the JAX
# package
AUDIO_FRAMES = 1024     # seamless-m4t: precomputed conv/mel frame embeddings
IMAGE_PATCHES = 1601    # llama-3.2-vision: 1 tile of 1600 patches + CLS


def resolve_device(device=None) -> torch.device:
    """`device` or "cuda"; raises when CUDA is asked for and absent —
    callers that want the CPU say so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU by default; pass "
            "device='cpu' to run on the CPU")
    return dev


class Model(nn.Module):
    """Stateless facade: init / caches / prefill / decode for one config."""

    def __init__(self, cfg: ModelConfig, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = B.cfg_dtype(cfg, dtype)
        self.device = resolve_device(device)

    # -- params -----------------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, Any]:
        return B.init_params(self.cfg, seed, self.dtype, self.device)

    # -- training ---------------------------------------------------------
    def forward_train(self, params, batch, remat: bool = True,
                      no_drop: bool = False):
        """(logits (B, T, V) fp32, aux loss) of whole sequences."""
        return B.forward_train(params, batch, self.cfg, remat=remat,
                               no_drop=no_drop)

    def loss_fn(self, params, batch, remat: bool = True,
                loss_chunk: int = 512
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy plus the MoE aux loss, as the JAX
        facade's: the T-1 predicting positions in chunks of `loss_chunk`
        (the last padded with zero-weight rows); each chunk's logsumexp
        minus the target logit in fp32, weighted by batch["loss_mask"] (all
        ones without one) and divided by the weight, at least 1. The chunks
        bound the forward's transient memory only: autograd keeps every
        chunk's fp32 logits for the backward, so the whole (B, T-1, V) is
        held until then, as the JAX `lax.map`'s residuals are. Returns
        (ce + aux, {"ce", "aux"})."""
        hidden, aux = B.forward_train(params, batch, self.cfg, remat=remat,
                                      return_hidden=True)
        h = hidden[:, :-1]
        targets = batch["tokens"][:, 1:].long()
        mask = batch.get("loss_mask")
        w = mask[:, 1:].float() if mask is not None \
            else torch.ones(targets.shape, device=h.device)
        Tm = h.shape[1]
        C = min(loss_chunk, Tm)
        pad = (-Tm) % C
        if pad:
            h = F.pad(h, (0, 0, 0, pad))
            targets = F.pad(targets, (0, pad))
            w = F.pad(w, (0, pad))
        sums = []
        for c in range(0, Tm + pad, C):
            lg = B.logits_head_train(params, h[:, c:c + C], self.cfg)
            nll = torch.logsumexp(lg, dim=-1) \
                - lg.gather(-1, targets[:, c:c + C, None])[..., 0]
            sums.append((nll * w[:, c:c + C]).sum())
        ce = torch.stack(sums).sum() / w.sum().clamp_min(1.0)
        return ce + aux, {"ce": ce, "aux": aux}

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, max_context: int, enc_len: int = 0,
                   prefill_chunk: int = 1):
        """Contiguous serving cache; a VLM or enc-dec cache holds `enc_len`
        cross keys a row (0: the family's default, `default_enc_len`)."""
        return B.init_cache(self.cfg, batch, max_context, self.dtype,
                            self.device, chunk=prefill_chunk,
                            enc_len=enc_len or default_enc_len(self.cfg))

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         n_slots: int = 0, enc_len: int = 0):
        """Physically paged serving cache: block pools (and one spare
        block past `num_blocks`, the target of invisible writes) plus
        `n_slots` rows of per-request state and cross K/V (`enc_len` keys,
        0 for the default) and the padding sentinel (DESIGN §9)."""
        return B.init_paged_cache(self.cfg, num_blocks, block_size,
                                  self.dtype, self.device, n_slots=n_slots,
                                  enc_len=enc_len or default_enc_len(self.cfg))

    @torch.no_grad()
    def forward(self, params, tokens, positions, cache, *,
                decode: bool = False, last_only: bool = False, tables=None,
                rows=None, extras=None):
        return B.forward_cached(params, tokens, positions, cache, self.cfg,
                                decode=decode, last_only=last_only,
                                tables=tables, rows=rows, extras=extras)

    def prefill(self, params, tokens, positions, cache, extras=None,
                last_only: bool = False):
        """Chunked prefill: tokens/positions (B, T), -1 positions = padding.
        `extras` ({"images"} or {"enc_frames"}, (B, S, d)) on a request's
        first chunk fill its cross K/V. Returns (logits (B, T, V) — (B, 1,
        V) with last_only — , cache)."""
        return self(params, tokens, positions, cache, last_only=last_only,
                    extras=extras)

    def decode_step(self, params, tokens, seq_lens, cache):
        """tokens: (B,) next input ids; seq_lens: (B,) their absolute
        positions (-1 = padding row). Returns (logits (B, V), cache)."""
        logits, cache = self(params, tokens[:, None], seq_lens[:, None], cache,
                             decode=True)
        return logits[:, 0], cache

    def prefill_paged(self, params, tokens, positions, tables, cache,
                      rows=None, extras=None, last_only: bool = False):
        """Chunked prefill through the paged pools: `tables` is the (B, MB)
        per-request physical block table, `rows` (B,) the requests' state
        slots (DESIGN §9), `extras` as `prefill`."""
        return self(params, tokens, positions, cache, last_only=last_only,
                    tables=tables, rows=rows, extras=extras)

    def decode_step_paged(self, params, tokens, seq_lens, tables, cache,
                          rows=None):
        """Paged decode step (DESIGN §9); a padding row's `rows` entry is
        the sentinel slot."""
        logits, cache = self(params, tokens[:, None], seq_lens[:, None],
                             cache, decode=True, tables=tables, rows=rows)
        return logits[:, 0], cache


def build_model(cfg: ModelConfig, dtype=None, device=None) -> Model:
    return Model(cfg, dtype, device)


def default_enc_len(cfg: ModelConfig) -> int:
    """Cross keys a request: the audio frames (enc-dec) or image patches
    (VLM) of the stub frontends; 0 for the other families."""
    if cfg.family == ArchFamily.ENCDEC:
        return AUDIO_FRAMES
    if cfg.family == ArchFamily.VLM:
        return IMAGE_PATCHES
    return 0
