"""Serving shardings of the port (DESIGN §5, §12): the serving half of the
JAX package's `distributed/sharding.py`, on `torch.distributed`.

* The DESIGN §5 name table (`spec_for`). A spec is a tuple with one entry
  per dim, as a `PartitionSpec` lists them: None, a mesh axis name, or a
  tuple of names. `validate` drops an axis that does not divide its dim
  (granite's odd vocab of 49155 keeps its embedding whole at m = 2).
  `serve_spec` strips the data axes, as `serve_param_shardings` does:
  serving shards over "model" only, and rows replicate over "data".
* `shard_params`: a rank's slices of whole params (the port's, or the
  JAX package's through `params.from_jax_params`), and `local_config`:
  the config of one rank's heads.
* `TensorParallel`: a model's view of its group, and the collectives its
  forward makes. Every branch whose down-projection is sharded on its
  input axis (attention's `wo`, self, cross or encoder; the SwiGLU's
  `w_down`; the MoE's expert stacks and its shared expert) leaves a
  partial sum, all-reduced before it joins the residual stream; a
  vocab-sharded embedding is a masked local lookup and an all-reduce, a
  vocab-sharded head an all-gather (every rank then holds the same full
  logits). The MoE's routed experts are cut on E (expert parallelism:
  rank r holds experts [r·E/m, (r+1)·E/m) and applies only those); where
  E does not divide the axis its stacks replicate, as the JAX package's
  `_validate` leaves them.
* `ServingGroup`: this process's place in a (data, model) layout: its
  tensor-parallel group, the ranks sharing its data index, and a gloo
  control group over every rank, on which rank 0's measured values are
  broadcast (`agree`). `launch.mesh.make_serving_group` installs it as
  the ambient serving group, the twin of `set_serving_mesh`.

The port splits no head: it serves a mesh only where the kv-heads divide
the model axis (and so the query heads too). K/V stored sharded on
head_dim (`kv_head_axes`' fallback) is not ported and raises, as do the
hybrid and SSM families (`check_tp`). The dense, MoE, VLM and enc-dec
families are served; the cross-attention K/V of the VLM and enc-dec
families hold a rank's kv-heads, as `serve_cache_shardings` shards them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.config.base import ArchFamily, ModelConfig

Spec = Tuple[Any, ...]

#: the families served under a mesh, and where each other one goes
TP_FAMILIES = (ArchFamily.DENSE, ArchFamily.MOE, ArchFamily.VLM,
               ArchFamily.ENCDEC)
LATER_SLICE = {
    ArchFamily.HYBRID: "the hybrid and SSM families' (RG-LRU channels over "
                       "\"model\", its single kv head sharded on head_dim, "
                       "the all-reduced gated norm)",
    ArchFamily.SSM: "the hybrid and SSM families' (mamba2's in_proj "
                    "segments, ssd_intra per rank, the all-reduced gated "
                    "norm)",
}


def spec_for(name: str, ndim: int, cfg: ModelConfig,
             fsdp: Sequence[str] = ("data",)) -> Spec:
    """Spec of one (stacked) param leaf by its path name: the JAX
    package's `_spec_for`, rule for rule."""
    f = tuple(fsdp) if len(fsdp) > 1 else fsdp[0]

    def stacked(*dims):  # the layer-stack axis, where present, replicates
        return (None,) * (ndim - len(dims)) + dims

    if name.endswith("embed"):
        return ("model", None)                    # (V, d)
    if name.endswith("lm_head"):
        return (None, "model")                    # (d, V)
    if "/moe/" in name or name.startswith("moe/"):
        if "router" in name:
            return stacked(f, None)               # (L, d, E)
        if "w_down" in name and "shared" not in name:
            return stacked("model", None, f)      # (L, E, f_e, d)
        if ("w_gate" in name or "w_up" in name) and "shared" not in name:
            return stacked("model", f, None)      # (L, E, d, f_e)
    if name.endswith(("attn/wq", "attn/wk", "attn/wv")):
        return stacked(f, "model")                # (L, d, out)
    if name.endswith("attn/wo"):
        return stacked("model", f)                # (L, H*hd, d)
    if name.endswith(("attn/bq", "attn/bk", "attn/bv")):
        return stacked("model")
    if name.endswith(("w_gate", "w_up")):
        return stacked(f, "model")
    if name.endswith("w_down"):
        return stacked("model", f)
    if name.endswith("mixer/in_proj"):
        return stacked(f, "model")                # (L, d, d_proj)
    if name.endswith("mixer/out_proj"):
        return stacked("model", f)                # (L, d_in, d)
    if name.endswith("mixer/conv_w"):
        return stacked(None, "model")             # (L, W, ch)
    if name.endswith(("mixer/conv_b", "mixer/norm_w")):
        return stacked("model")
    if name.endswith(("dt_bias", "A_log", "mixer/D")):
        return stacked(None)                      # (L, H)
    if name.endswith(("rec/w_x", "rec/w_gate_branch")):
        return stacked(f, "model")                # (L, d, w)
    if name.endswith("rec/w_out"):
        return stacked("model", f)                # (L, w, d)
    if name.endswith(("rec/w_a", "rec/w_i", "rec/conv_w")):
        return stacked(None, "model")             # (L, w, w), (L, W, w)
    if name.endswith(("rec/conv_b", "rec/b_a", "rec/b_i", "rec/lam")):
        return stacked("model")
    return ()                                     # norms, gates: replicate


def validate(spec: Spec, shape: Sequence[int],
             sizes: Mapping[str, int]) -> Spec:
    """One entry per dim of `shape`; an axis (or group of axes) whose size
    does not divide its dim is dropped (the JAX package's `_validate`)."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        if ax is None:
            out.append(None)
            continue
        size = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            size *= sizes[a]
        out.append(ax if dim % size == 0 else None)
    return tuple(out)


def _strip(ax):
    """A spec entry with every axis but "model" replicated."""
    if isinstance(ax, tuple):
        keep = tuple(a for a in ax if a == "model")
        return keep[0] if keep else None
    return ax if ax == "model" else None


def serve_spec(name: str, shape: Sequence[int], cfg: ModelConfig,
               m: int) -> Spec:
    """A leaf's serving spec on a model axis of m: the §5 rule with every
    data axis replicated, validated against the shape
    (`serve_param_shardings`)."""
    spec = tuple(_strip(ax) for ax in spec_for(name, len(shape), cfg))
    return validate(spec, shape, {"model": m})


def kv_head_axes(m: int, kv: int, hd: int) -> Tuple[Optional[str],
                                                     Optional[str]]:
    """Which cache axis takes "model": kv-heads when they divide it,
    head_dim as the fallback, else neither (DESIGN §5)."""
    if kv % m == 0:
        return "model", None
    if hd % m == 0:
        return None, "model"
    return None, None


def check_tp(cfg: ModelConfig, m: int) -> None:
    """Raise unless the port serves `cfg` on a model axis of m."""
    if cfg.family not in TP_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: tensor-parallel serving of the {cfg.family.value} "
            f"family is not ported yet; it is a later slice, "
            f"{LATER_SLICE[cfg.family]}")
    kv_ax, hd_ax = kv_head_axes(m, cfg.num_kv_heads, cfg.resolved_head_dim)
    if kv_ax is None:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.num_kv_heads} kv-heads on a model axis of "
            f"{m}: " + ("the head_dim fallback (K/V stored sharded on "
                        "head_dim) is not ported" if hd_ax else
                        "neither kv-heads nor head_dim divide the axis"))


def local_config(cfg: ModelConfig, m: int) -> ModelConfig:
    """The config of one rank's heads: H/m query heads on KV/m kv-heads at
    the same head_dim. Heads are kv-major, so query heads
    [r·H/m, (r+1)·H/m) read exactly kv-heads [r·KV/m, (r+1)·KV/m)."""
    check_tp(cfg, m)
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // m,
                               num_kv_heads=cfg.num_kv_heads // m,
                               head_dim=cfg.resolved_head_dim)


def shard_params(params: Dict[str, Any], cfg: ModelConfig, rank: int,
                 m: int, prefix: str = "") -> Dict[str, Any]:
    """Rank `rank`'s slices of whole params on a model axis of m: each
    leaf cut along the axis its `serve_spec` puts on "model" (the rank's
    contiguous block, copied, so the whole leaf can be freed), else kept
    whole (replicated)."""
    if not 0 <= rank < m:
        raise ValueError(f"rank {rank} outside a model axis of {m}")
    out: Dict[str, Any] = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out[k] = shard_params(v, cfg, rank, m, name + "/")
            continue
        spec = serve_spec(name, tuple(v.shape), cfg, m)
        axis = spec.index("model") if "model" in spec else -1
        if axis < 0 or m == 1:
            out[k] = v
        else:
            n = v.shape[axis] // m
            out[k] = v.narrow(axis, rank * n, n).clone()
    return out


# ---------------------------------------------------------------------------
# groups and collectives


@dataclasses.dataclass
class ServingGroup:
    """This process's rank in a mesh of `mesh_shape` (the last axis
    "model"): the ranks sharing its data index form `tp`, its
    tensor-parallel group, and data replicas run the same computation;
    `control` is a gloo group over every rank, on the host, whatever the
    backend of `tp`."""
    mesh_shape: Tuple[int, ...]
    rank: int
    world: int
    backend: str
    tp: Any
    control: Any

    @property
    def model_size(self) -> int:
        return self.mesh_shape[-1]

    @property
    def tp_rank(self) -> int:
        return self.rank % self.model_size

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum x over the tensor-parallel group, in place; returns x."""
        dist.all_reduce(x, group=self.tp)
        return x

    def agree(self, values: Sequence[float]) -> List[float]:
        """Rank 0's `values` on every rank: one broadcast of a small
        float64 host tensor on the control group. Every rank runs the
        engine's host code, so a measured value that feeds a decision
        (a clock, a step's wait) must be one rank's, or the ranks decide
        differently and their collectives no longer match."""
        t = torch.tensor(list(values), dtype=torch.float64)
        dist.broadcast(t, 0, group=self.control)
        return t.tolist()


@dataclasses.dataclass
class TensorParallel:
    """A model's view of its serving group: the config of its local heads
    and which of its outputs are split over the model axis."""
    group: ServingGroup
    cfg: ModelConfig            # the rank's local heads (`local_config`)
    mlp_split: bool             # w_gate / w_up / w_down cut on d_ff
    vocab_split: bool           # embed (and lm_head) cut on the vocab
    expert_split: bool = False  # the MoE's expert stacks cut on E
    shared_split: bool = False  # the MoE's shared expert cut on its d_ff

    def experts(self, n: int) -> slice:
        """The experts of n that this rank applies: its contiguous slice
        of E when the stacks are cut on E, else all of them."""
        if not self.expert_split:
            return slice(0, n)
        k = n // self.m
        return slice(self.rank * k, (self.rank + 1) * k)

    @property
    def m(self) -> int:
        return self.group.model_size

    @property
    def rank(self) -> int:
        return self.group.tp_rank

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """A partial sum made whole on every rank."""
        return self.group.all_reduce(x)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor):
        """The embedding rows of `tokens`: a masked lookup in the rank's
        vocab shard, then an all-reduce (each row has one owner, the other
        ranks add exact zeros)."""
        if not self.vocab_split:
            return table[tokens]
        n = table.shape[0]
        local = tokens - self.rank * n
        hit = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)]
        return self.reduce(torch.where(hit[..., None], rows,
                                       torch.zeros_like(rows)))

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """(..., V/m) vocab-shard logits -> (..., V) on every rank: each
        rank writes its shard into zeros and the group sums them (an
        all-gather through the all-reduce, exact)."""
        if not self.vocab_split:
            return logits
        n = logits.shape[-1]
        out = logits.new_zeros(logits.shape[:-1] + (n * self.m,))
        out[..., self.rank * n:(self.rank + 1) * n] = logits
        return self.reduce(out)


def tensor_parallel(cfg: ModelConfig, group: ServingGroup) -> TensorParallel:
    """`cfg`'s layout on `group`'s model axis (raises where the port
    serves no mesh: `check_tp`)."""
    m = group.model_size
    lcfg = local_config(cfg, m)
    L_, d = cfg.num_layers, cfg.d_model
    mlp = serve_spec("layers/mlp/w_down", (L_, cfg.d_ff, d), cfg, m)
    vocab = serve_spec("embed", (cfg.vocab_size, d), cfg, m)
    experts = shared = ()
    if cfg.moe is not None:
        E, f_e = cfg.moe.num_experts, cfg.moe.expert_ff_dim
        experts = serve_spec("layers/moe/w_down", (L_, E, f_e, d), cfg, m)
        if cfg.moe.shared_ff_dim:
            shared = serve_spec("layers/moe/shared/w_down",
                                (L_, cfg.moe.shared_ff_dim, d), cfg, m)
    return TensorParallel(group, lcfg, mlp_split=mlp[1] == "model",
                          vocab_split=vocab[0] == "model",
                          expert_split="model" in experts[1:2],
                          shared_split="model" in shared[1:2])


# The process's ambient serving group (DESIGN §12), installed by
# `launch.mesh.make_serving_group`: a module slot, as the JAX package's
# serving mesh, read by the CLI's rank processes.
_SERVING_GROUP: Optional[ServingGroup] = None


def set_serving_group(group: Optional[ServingGroup]
                      ) -> Optional[ServingGroup]:
    """Install `group` as the ambient serving group; returns the previous
    one."""
    global _SERVING_GROUP
    prev, _SERVING_GROUP = _SERVING_GROUP, group
    return prev


def serving_group() -> Optional[ServingGroup]:
    return _SERVING_GROUP
