"""Public model facade: an `nn.Module` over the plain functions of
`backbone`, bound to one ModelConfig, one device and one dtype.

Params are a plain nested dict of tensors (the JAX package's layout), made
by `init` or converted by `params.from_jax_params`, and passed to each call
as in the JAX facade. The entry points run on the card unless the caller
asks for the CPU: `device` defaults to "cuda", and a missing GPU raises.
Serving (`forward` and the calls over it) runs without autograd; training
(`forward_train`, `loss_fn`) takes params that are leaves requiring grad
(`training.train_loop.trainable`), on one device or a rank's shards under
a group.

Under tensor-parallel serving (DESIGN §12, `group=`) the model is one
rank's: it carries the group and its local shapes
(`distributed.sharding.TensorParallel`); `init` draws the whole weights
from the seed and keeps the rank's slices, cutting each tensor as soon as
it is drawn (`init_shard`), and the caches hold its kv-heads (the cross
K/V too). Weights made elsewhere (`params.from_jax_params`) are cut with
`shard`. A rank trains its shards too: the training forward takes the
group's collectives with their backward (`backbone.forward_train`), and
the loss reads the vocab-sharded logits where they lie (`vocab_nll`: the
max and the sum of exps all-reduced, the target logit from the rank that
owns it), the port's form of the JAX loss's `maybe_constrain` on the
vocab axis.

`input_specs` gives the dry run's inputs of an (arch x input-shape) as
meta tensors (`launch.dryrun`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import ArchFamily, InputShape, ModelConfig
from repro_torch.distributed.sharding import (ServingGroup, shard_leaf,
                                              shard_params, tensor_parallel)
from repro_torch.models import backbone as B
from repro_torch.models.layers import ParamInit
from repro_torch.params import named_leaves

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
                 device=None, group: Optional[ServingGroup] = None):
        """`group`: this rank's serving group (`launch.mesh.
        make_serving_group`); the model then serves its tensor-parallel
        shard (raises for a family or head count the port does not shard:
        `sharding.check_tp`)."""
        super().__init__()
        self.cfg = cfg
        self.dtype = B.cfg_dtype(cfg, dtype)
        self.device = resolve_device(device)
        self.group = group
        self.tp = tensor_parallel(cfg, group) if group is not None else None
        #: the config the forward and the caches see: the rank's heads
        self.local_cfg = self.tp.cfg if self.tp is not None else cfg

    # -- params -----------------------------------------------------------
    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights from `seed`; under a group the rank's slices of
        the whole weights the seed gives (the same on every rank), never
        holding more than its slices and one whole tensor (`init_shard`)."""
        if self.tp is None:
            return B.init_params(self.cfg, seed, self.dtype, self.device)
        return init_shard(self.cfg, seed, self.dtype, self.device,
                          self.tp.rank, self.tp.m)

    def shard(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's slices of whole params (`params` itself without a
        group)."""
        if self.tp is None:
            return params
        return shard_params(params, self.cfg, self.tp.rank, self.tp.m)

    # -- training ---------------------------------------------------------
    def forward_train(self, params, batch, remat: bool = True,
                      no_drop: bool = False):
        """(logits (B, T, V) fp32, aux loss) of whole sequences (a rank's
        under a group: its shards, the logits gathered whole)."""
        return B.forward_train(params, batch, self.local_cfg, remat=remat,
                               no_drop=no_drop, tp=self.tp)

    def loss_fn(self, params, batch, remat: bool = True,
                loss_chunk: int = 512
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy plus the MoE aux loss, as the JAX
        facade's: the T-1 predicting positions in chunks of `loss_chunk`
        (the last padded with zero-weight rows); each chunk's logsumexp
        minus the target logit in fp32 (`vocab_nll`), weighted by
        batch["loss_mask"] (all ones without one) and divided by the
        weight, at least 1. The chunks bound the forward's transient
        memory only: autograd keeps every chunk's fp32 logits for the
        backward, so the whole (B, T-1, V) is held until then, as the JAX
        `lax.map`'s residuals are. Under a group each rank holds its vocab
        shard's (B, C, V/m) only. Returns (ce + aux, {"ce", "aux"})."""
        cfg, tp = self.local_cfg, self.tp
        hidden, aux = B.forward_train(params, batch, cfg, remat=remat,
                                      return_hidden=True, tp=tp)
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
        vtp = tp if tp is not None and tp.vocab_split else None
        sums = []
        for c in range(0, Tm + pad, C):
            nll = vocab_nll(B.logits_shard(params, h[:, c:c + C], cfg, vtp),
                            targets[:, c:c + C], vtp)
            sums.append((nll * w[:, c:c + C]).sum())
        ce = torch.stack(sums).sum() / w.sum().clamp_min(1.0)
        return ce + aux, {"ce": ce, "aux": aux}

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, max_context: int, enc_len: int = 0,
                   prefill_chunk: int = 1, seq_shard: bool = False):
        """Contiguous serving cache; a VLM or enc-dec cache holds `enc_len`
        cross keys a row (0: the family's default, `default_enc_len`).
        `seq_shard`: this data rank's contiguous share of the attention
        slots, cut over the group's data axis (`decode_step(seq_shard=
        True)`)."""
        return B.init_cache(self.local_cfg, batch, max_context, self.dtype,
                            self.device, chunk=prefill_chunk,
                            enc_len=enc_len or default_enc_len(self.cfg),
                            tp=self.tp,
                            seq_parts=self.group.data_size
                            if self._seq(seq_shard) else 1)

    def _seq(self, seq_shard: bool) -> bool:
        if seq_shard and self.group is None:
            raise ValueError("a sequence-sharded cache needs a serving "
                             "group with a data axis")
        return seq_shard

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         n_slots: int = 0, enc_len: int = 0):
        """Physically paged serving cache: block pools (and one spare
        block past `num_blocks`, the target of invisible writes) plus
        `n_slots` rows of per-request state and cross K/V (`enc_len` keys,
        0 for the default) and the padding sentinel (DESIGN §9)."""
        return B.init_paged_cache(self.local_cfg, num_blocks, block_size,
                                  self.dtype, self.device, n_slots=n_slots,
                                  enc_len=enc_len or default_enc_len(self.cfg),
                                  tp=self.tp)

    @torch.no_grad()
    def forward(self, params, tokens, positions, cache, *,
                decode: bool = False, last_only: bool = False, tables=None,
                rows=None, extras=None, seq_shard: bool = False):
        return B.forward_cached(params, tokens, positions, cache,
                                self.local_cfg, decode=decode,
                                last_only=last_only, tables=tables,
                                rows=rows, extras=extras, tp=self.tp,
                                seq_shard=seq_shard)

    def prefill(self, params, tokens, positions, cache, extras=None,
                last_only: bool = False):
        """Chunked prefill: tokens/positions (B, T), -1 positions = padding.
        `extras` ({"images"} or {"enc_frames"}, (B, S, d)) on a request's
        first chunk fill its cross K/V. Returns (logits (B, T, V) — (B, 1,
        V) with last_only — , cache)."""
        return self(params, tokens, positions, cache, last_only=last_only,
                    extras=extras)

    def decode_step(self, params, tokens, seq_lens, cache,
                    seq_shard: bool = False):
        """tokens: (B,) next input ids; seq_lens: (B,) their absolute
        positions (-1 = padding row). Returns (logits (B, V), cache).
        `seq_shard`: `cache` holds this data rank's slots
        (`init_cache(seq_shard=True)`), and each attention layer combines
        the data ranks' partial results (the JAX dry run's batch-1
        long-context layout, `cache_specs(seq_shard=True)`)."""
        logits, cache = self(params, tokens[:, None], seq_lens[:, None], cache,
                             decode=True,
                             seq_shard=self._seq(seq_shard))
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


class _Cut(ParamInit):
    """Draws as ParamInit does and cuts each tensor, as soon as it is
    made, to rank `rank`'s slice of the leaf `names` gives it next
    (`sharding.shard_leaf`). The whole tensor is then freed; the
    generator has drawn exactly what the whole init draws."""

    def __init__(self, seed, dtype, device, cfg, rank, m, names):
        super().__init__(seed, dtype, device)
        self.cfg, self.rank, self.m = cfg, rank, m
        self.names = iter(names)

    def made(self, t):
        return shard_leaf(next(self.names), t, self.cfg, self.rank, self.m)


class _Record(ParamInit):
    """Makes only the shapes (the meta device) and records each tensor in
    the order it is made."""

    def __init__(self, dtype):
        super().__init__(0, dtype, "meta")
        self.order = []

    def made(self, t):
        self.order.append(t)
        return t


def init_shard(cfg: ModelConfig, seed: int, dtype: torch.dtype, device,
               rank: int, m: int) -> Dict[str, Any]:
    """`shard_params(init_params(cfg, seed, ...), cfg, rank, m)`, equal to
    it bit for bit, drawn without ever holding the whole weights: a run on
    the meta device names each tensor in the order the init makes it,
    then the real init cuts each one as it is drawn. Two ranks of a large
    model on one card (tp (b) of chip_smoke) then fit where whole draws
    would not. An init whose made tensors are not its leaves one for one
    is drawn whole and cut (every family's are, since the SSM's dt_bias,
    A_log and D and the RG-LRU's lam are made as leaves)."""
    rec = _Record(dtype)
    names = {id(t): n for n, t in named_leaves(
        B.init_params(cfg, seed, dtype, "meta", init=rec))}
    if m == 1 or len(names) != len(rec.order) \
            or any(id(t) not in names for t in rec.order):
        return shard_params(B.init_params(cfg, seed, dtype, device), cfg,
                            rank, m)
    return B.init_params(cfg, seed, dtype, device, init=_Cut(
        seed, dtype, device, cfg, rank, m, [names[id(t)] for t in rec.order]))


def vocab_nll(lg, targets, tp=None):
    """logsumexp(lg) - lg[target] along the last axis, in fp32, of logits
    (..., n) that are the whole vocab, or under `tp` the rank's shard of
    it (rows [r·n, (r+1)·n)): the max (without gradient) and the sum of
    exps all-reduced, and the target logit taken on the rank that owns it
    and all-reduced, so no rank forms the whole (..., V). The one-device
    loss takes the same ops, so a one-rank group is it bit for bit."""
    n = lg.shape[-1]
    mx = lg.detach().amax(-1, keepdim=True)
    local = targets - (0 if tp is None else tp.rank * n)
    hit = (local >= 0) & (local < n)
    if tp is not None:
        mx = tp.max(mx)
    s = torch.exp(lg - mx).sum(-1)
    tgt = torch.where(hit, lg.gather(-1, local.clamp(0, n - 1)[..., None]
                                     )[..., 0], 0.0)
    if tp is not None:
        s, tgt = tp.reduce(s), tp.reduce(tgt)
    return torch.log(s) + mx[..., 0] - tgt


def build_model(cfg: ModelConfig, dtype=None, device=None,
                group: Optional[ServingGroup] = None) -> Model:
    return Model(cfg, dtype, device, group)


def default_enc_len(cfg: ModelConfig) -> int:
    """Cross keys a request: the audio frames (enc-dec) or image patches
    (VLM) of the stub frontends; 0 for the other families."""
    if cfg.family == ArchFamily.ENCDEC:
        return AUDIO_FRAMES
    if cfg.family == ArchFamily.VLM:
        return IMAGE_PATCHES
    return 0


def input_specs(cfg: ModelConfig, shape: InputShape,
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The inputs of (arch x input-shape) as meta tensors, the JAX
    package's `input_specs` (DESIGN §4), at the global batch:

    train   {tokens (B, T) int32, and (B, enc_len, d) enc_frames or images}
    prefill {tokens, positions (B, T) int32, the cache of a T-token chunk,
             extras {enc_frames | images}}
    decode  {tokens, seq_lens (B,) int32, the cache at seq_len context}

    `dtype`: the working dtype (the config's by default)."""
    B_, T = shape.global_batch, shape.seq_len
    dt = B.cfg_dtype(cfg, dtype)
    enc_len = default_enc_len(cfg)

    def meta(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    extras = {B.extras_key(cfg): meta(B_, enc_len, cfg.d_model, dtype=dt)} \
        if enc_len else {}
    if shape.kind == "train":
        return {"tokens": meta(B_, T), **extras}
    chunk = T if shape.kind == "prefill" else 1
    cache = B.init_cache(cfg, B_, T, dt, "meta", chunk=chunk,
                         enc_len=enc_len)
    if shape.kind == "prefill":
        specs = {"tokens": meta(B_, T), "positions": meta(B_, T),
                 "cache": cache}
        if extras:
            specs["extras"] = extras
        return specs
    return {"tokens": meta(B_), "seq_lens": meta(B_), "cache": cache}
