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
  logits). Where a rank needs whole an activation it holds a slice of
  (the RG-LRU's gate products, the K/V under the head_dim fallback) it
  gathers it (`gather`). The MoE's routed experts are cut on E (expert
  parallelism: rank r holds experts [r·E/m, (r+1)·E/m) and applies only
  those); where E does not divide the axis its stacks replicate, as the
  JAX package's `_validate` leaves them.
* `ServingGroup`: this process's place in a (data, model) layout: its
  tensor-parallel group, the ranks sharing its data index, and a gloo
  control group over every rank, on which rank 0's measured values are
  broadcast (`agree`). `launch.mesh.make_serving_group` installs it as
  the ambient serving group, the twin of `set_serving_mesh`.

Every layout the JAX package serves is served. Where the kv-heads divide
the model axis a rank holds KV/m of them and the H/m query heads that read
them. Elsewhere the head_dim fallback applies (`kv_head_axes`: a rank's
cache holds hd/m channels of every kv-head, gathered to the whole hd
before each attention read), and the rank's `wq` columns and `wo` rows
stay the §5 rule's flat cut of H·hd, which may cross a head boundary
(starcoder2-7b's 36 heads at m = 8). The rank's attention then runs on a
span of whole query heads (`head_span`): its own heads where they are
whole and read one kv-head, else the heads its columns touch widened to
whole kv groups, their q gathered over the group once a layer; the rank
keeps its flat columns of the output for `wo`. The cross K/V of the VLM
and enc-dec families take the same rule (`serve_cache_shardings`). mamba2's
mixer is cut by segment (`segments`: its z, x and dt columns and its x
conv channels per rank, B and C whole) with the gated norm's sum of
squares all-reduced, and RecurrentGemma's RG-LRU channels per rank, its
gate products reading the whole post-conv x through one gather.

A batch-1 decode may also cut its contiguous cache's slots over the data
axis (`cache_specs(seq_shard=True)`, the JAX dry run's long-context
layout): each data rank attends over its slots (a partial flash decode),
the ranks' partial (O, m, l) are gathered over the data axis
(`ServingGroup.gather_data`) and combined.

The training half (the dry run's, `launch.dryrun`): the FSDP x TP specs of
the JAX package's `param_shardings`, `batch_shardings`, `cache_shardings`
and `decode_input_shardings` over a `{axis: size}` map (`param_specs`,
`batch_specs`, `cache_specs`, `decode_input_specs`), a rank's shard of a
leaf under a spec (`local_shape`, `local_bytes`), and the collectives of a
training forward under a group with their backward (`TensorParallel`:
the Megatron pair `reduce` / `copy`, `sum` for a total that each rank
reads its own share of, and `gather`), so that a tensor-parallel training
step gives each rank its slice of the one-device gradient.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.config.base import ArchFamily, ModelConfig
from repro_torch.models.backbone import init_params
from repro_torch.models.ssm import ssm_dims
from repro_torch.params import named_leaves

Spec = Tuple[Any, ...]

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
    """Raise unless the port serves `cfg` on a model axis of m: mamba2's
    SSD heads and the RG-LRU channels must divide the axis, and the
    kv-heads or, as the fallback, head_dim (DESIGN §5)."""
    def refuse(why: str):
        raise NotImplementedError(f"{cfg.name} on a model axis of {m}: "
                                  f"{why}")

    if cfg.family == ArchFamily.SSM:
        _, H, _, _ = ssm_dims(cfg)
        if H % m:
            refuse(f"its {H} SSD heads do not divide the axis")
    if cfg.family == ArchFamily.HYBRID \
            and (cfg.rglru.lru_width or cfg.d_model) % m:
        refuse("its RG-LRU channels do not divide the axis")
    KV = cfg.num_kv_heads
    if cfg.num_heads and kv_head_axes(m, KV, cfg.resolved_head_dim) \
            == (None, None):
        refuse(f"neither its {KV} kv-heads nor head_dim "
               f"{cfg.resolved_head_dim} divide the axis")


def head_span(cfg: ModelConfig, m: int, rank: int) -> Tuple[int, int]:
    """The query heads [h0, h1) rank `rank`'s attention runs on under the
    head_dim fallback. Its `wq` columns are the flat [r·H·hd/m, (r+1)·H·hd/m)
    of H·hd, which touch heads [⌊r·H/m⌋, ⌈(r+1)·H/m⌉). Where those read
    one kv-head (heads are kv-major: head h reads kv-head h // G) the span
    is theirs; else it is widened to whole kv groups, [G·⌊h0/G⌋,
    G·⌈h1/G⌉), so that the kernels read the span's kv-heads as they lie."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G = H // KV
    h0, h1 = rank * H // m, -(-(rank + 1) * H // m)
    if h0 // G == (h1 - 1) // G:
        return h0, h1
    return G * (h0 // G), G * -(-h1 // G)


def q_gathered(cfg: ModelConfig, m: int) -> bool:
    """Whether a layout's ranks gather q over the group: under the head_dim
    fallback, where some rank's span (`head_span`) is not its own whole
    heads. Every rank of the group then gathers, so the collectives
    match."""
    H = cfg.num_heads
    if not H or kv_head_axes(m, cfg.num_kv_heads,
                             cfg.resolved_head_dim)[1] is None:
        return False
    return any(head_span(cfg, m, r) != (r * H // m, (r + 1) * H // m)
               for r in range(m))


def local_config(cfg: ModelConfig, m: int, rank: int = 0) -> ModelConfig:
    """The config of rank `rank`'s attention heads: H/m query heads at the
    same head_dim on KV/m kv-heads where the kv-heads divide the axis
    (heads are kv-major, so query heads [r·H/m, (r+1)·H/m) read exactly
    kv-heads [r·KV/m, (r+1)·KV/m)); under the head_dim fallback the
    `head_span` of query heads on all KV kv-heads, which the cache holds
    hd/m of (the span reads `TensorParallel.kv_heads` of them). The
    widths of mamba2's mixer and of the RG-LRU stay whole here: a rank's
    share of them comes from `TensorParallel.m`."""
    check_tp(cfg, m)
    H, kv = cfg.num_heads, cfg.num_kv_heads
    if not H or kv % m == 0:
        return dataclasses.replace(cfg, num_heads=H // m,
                                   num_kv_heads=kv // m,
                                   head_dim=cfg.resolved_head_dim)
    h0, h1 = head_span(cfg, m, rank)
    return dataclasses.replace(cfg, num_heads=h1 - h0, num_kv_heads=kv,
                               head_dim=cfg.resolved_head_dim)


def segments(name: str, cfg: ModelConfig
             ) -> Optional[List[Tuple[int, bool]]]:
    """The port's cut of mamba2's `in_proj` and `conv_*` along their last
    axis: (width, cut) a segment, in order, a cut segment split over the
    ranks and a whole one kept on every rank; None for every other leaf.
    `in_proj`'s columns are z, x, B, C and dt (`d_proj = 2 d_in + 2 N +
    H`): a rank takes its d_in/m of z and x and its H/m of dt, and B and
    C whole (one group: every head reads them); the conv's channels are
    x, B and C alike. The §5 rule cuts the flat columns contiguously,
    which GSPMD reshards and explicit slices cannot: rank 0 would hold
    all of z and part of x."""
    if cfg.family != ArchFamily.SSM:
        return None
    d_in, H, _, N = ssm_dims(cfg)
    if name.endswith("mixer/in_proj"):
        return [(d_in, True), (d_in, True), (N, False), (N, False),
                (H, True)]
    if name.endswith(("mixer/conv_w", "mixer/conv_b")):
        return [(d_in, True), (N, False), (N, False)]
    return None


def shard_leaf(name: str, t: torch.Tensor, cfg: ModelConfig, rank: int,
               m: int) -> torch.Tensor:
    """Rank `rank`'s slice of one whole leaf on a model axis of m, copied
    (so the whole leaf can be freed): cut by `segments` where it has
    them, else along the axis its `serve_spec` puts on "model" (the
    rank's contiguous block); `t` itself where it replicates."""
    if m == 1:
        return t
    segs = segments(name, cfg)
    if segs is not None:
        parts, at = [], 0
        for width, cut in segs:
            n = width // m if cut else width
            parts.append(t.narrow(-1, at + (rank * n if cut else 0), n))
            at += width
        return torch.cat(parts, -1)
    spec = serve_spec(name, tuple(t.shape), cfg, m)
    if "model" not in spec:
        return t
    axis = spec.index("model")
    n = t.shape[axis] // m
    return t.narrow(axis, rank * n, n).clone()


def shard_params(params: Dict[str, Any], cfg: ModelConfig, rank: int,
                 m: int, prefix: str = "") -> Dict[str, Any]:
    """Rank `rank`'s slices of whole params on a model axis of m, leaf by
    leaf (`shard_leaf`)."""
    if not 0 <= rank < m:
        raise ValueError(f"rank {rank} outside a model axis of {m}")
    out: Dict[str, Any] = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        out[k] = shard_params(v, cfg, rank, m, name + "/") \
            if isinstance(v, dict) else shard_leaf(name, v, cfg, rank, m)
    return out


# ---------------------------------------------------------------------------
# the training layout: FSDP over the data axes x TP over "model"


#: what the pod axis does (`fsdp_axes`): "fsdp" shards params over
#: (pod, data); "dp" keeps FSDP within a pod and makes the pod axis pure
#: data parallelism (the JAX package's REPRO_POD_MODE=dp)
POD_MODES = ("fsdp", "dp")


def fsdp_axes(sizes: Mapping[str, int], pod_mode: str = "fsdp"
              ) -> Tuple[str, ...]:
    """The axes that shard params and optimizer state."""
    if pod_mode not in POD_MODES:
        raise ValueError(f"pod_mode {pod_mode!r} not in {POD_MODES}")
    if "pod" in sizes and pod_mode != "dp":
        return ("pod", "data")
    return ("data",)


def data_axes(sizes: Mapping[str, int]) -> Tuple[str, ...]:
    """The axes that shard the batch: always the pod axis too."""
    return ("pod", "data") if "pod" in sizes else ("data",)


def _entry(axes: Tuple[str, ...]):
    return axes if len(axes) > 1 else axes[0]


def _specs(tree, one, prefix: str = ""):
    return {k: _specs(v, one, f"{prefix}{k}/") if isinstance(v, dict)
            else one(f"{prefix}{k}", v) for k, v in tree.items()}


def param_specs(params, cfg: ModelConfig, sizes: Mapping[str, int],
                pod_mode: str = "fsdp"):
    """The spec of every param leaf (tensors or meta tensors), a tree of
    the params' shape: the §5 rule over the FSDP axes, validated
    (`param_shardings`)."""
    f = fsdp_axes(sizes, pod_mode)
    return _specs(params, lambda name, t: validate(
        spec_for(name, t.dim(), cfg, f), tuple(t.shape), sizes))


def batch_specs(batch, sizes: Mapping[str, int]):
    """Every batch leaf's leading axis over the data axes
    (`batch_shardings`)."""
    bs = _entry(data_axes(sizes))
    return _specs(batch, lambda name, t: validate(
        (bs,) + (None,) * (t.dim() - 1), tuple(t.shape), sizes))


def cache_specs(cache, sizes: Mapping[str, int], seq_shard: bool = False):
    """A contiguous cache's specs (`cache_shardings`): rows over the data
    axes, K/V on kv-heads or head_dim (`kv_head_axes`), the recurrent
    state on its channels; with `seq_shard` (batch-1 long-context decode)
    the K/V and `pos` slots over "data" instead."""
    fs = _entry(data_axes(sizes))
    rows = None if seq_shard else fs

    def one(name, t):
        shape = tuple(t.shape)
        if name in ("k", "v", "cross_k", "cross_v"):
            kv_ax, hd_ax = kv_head_axes(sizes["model"], shape[3], shape[4])
            spec = (None, None, "data", kv_ax, hd_ax) \
                if seq_shard and name in ("k", "v") \
                else (None, fs, None, kv_ax, hd_ax)
        elif name == "pos":
            spec = (None, "data") if seq_shard else (fs, None)
        elif name == "conv":                        # (L, B, W-1, ch)
            spec = (None, rows, None, "model")
        elif name == "rec":                         # (L, B, w)
            spec = (None, rows, "model")
        elif name == "ssm":                         # (L, B, H, P, N)
            spec = (None, rows, None, None, None)
        else:
            spec = ()
        return validate(spec, shape, sizes)

    return _specs(cache, one)


def decode_input_specs(sizes: Mapping[str, int], batch: int) -> Spec:
    """The spec of a decode step's (B,) tokens and seq_lens: over the data
    axes where they divide B, else replicated
    (`decode_input_shardings`)."""
    f = data_axes(sizes)
    return (_entry(f),) if batch % math.prod(sizes[a] for a in f) == 0 \
        else ()


def local_shape(shape: Sequence[int], spec: Spec,
                sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """One rank's shard of `shape` under a validated `spec`."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        out.append(dim // math.prod(sizes[a] for a in axes))
    return tuple(out)


def local_bytes(t: torch.Tensor, spec: Spec,
                sizes: Mapping[str, int]) -> int:
    """The bytes of one rank's shard of `t` under `spec`."""
    return math.prod(local_shape(tuple(t.shape), spec, sizes)) \
        * t.element_size()


# ---------------------------------------------------------------------------
# groups and collectives


#: the all-gather into one tensor: `all_gather_single` where torch has it
#: (2.13 has it and deprecates the old name, with a warning), else
#: `all_gather_into_tensor`. The old name calls the new one, so both
#: dispatch c10d's `_allgather_base_`, the op the graph audit counts.
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


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
    #: the ranks of this rank's pod and model index along the "data" axis
    #: (None: not built, a one-rank data axis)
    dp: Any = None

    @property
    def model_size(self) -> int:
        return self.mesh_shape[-1]

    @property
    def tp_rank(self) -> int:
        return self.rank % self.model_size

    @property
    def data_size(self) -> int:
        """The "data" axis (the second last; 1 on a one-axis mesh)."""
        return self.mesh_shape[-2] if len(self.mesh_shape) > 1 else 1

    @property
    def data_rank(self) -> int:
        return (self.rank // self.model_size) % self.data_size

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum x (or its max, `op` "max") over the tensor-parallel group,
        in place; returns x."""
        dist.all_reduce(x, op=_OPS[op], group=self.tp)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(..., n) of each rank -> (..., m·n) on every rank, the ranks'
        slices in rank order along the last axis: one all-gather into a
        tensor of a fixed shape (it captures in a CUDA graph on NCCL),
        then the rank axis moved beside the last."""
        m = self.model_size
        out = x.new_empty((m * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather(out, x.contiguous(), group=self.tp)
        return out.view((m,) + tuple(x.shape)).movedim(0, -2).reshape(
            tuple(x.shape[:-1]) + (m * x.shape[-1],))

    def gather_data(self, x: torch.Tensor) -> torch.Tensor:
        """x of each rank of the data group -> (data, *x.shape) on every
        one of them, in data-rank order: one all-gather of a fixed shape
        (a sequence-sharded decode's partial (O, m, l), once a layer)."""
        n = self.data_size
        if n == 1:
            return x[None]
        out = x.new_empty((n * x.numel(),))
        _all_gather(out, x.contiguous().view(-1), group=self.dp)
        return out.view((n,) + tuple(x.shape))

    def agree(self, values: Sequence[float]) -> List[float]:
        """Rank 0's `values` on every rank: one broadcast of a small
        float64 host tensor on the control group. Every rank runs the
        engine's host code, so a measured value that feeds a decision
        (a clock, a step's wait) must be one rank's, or the ranks decide
        differently and their collectives no longer match."""
        t = torch.tensor(list(values), dtype=torch.float64)
        dist.broadcast(t, 0, group=self.control)
        return t.tolist()


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _summed(group, x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x summed over the group (x is left as it is:
    autograd may hand the same gradient to another branch)."""
    return group.all_reduce(x.clone(memory_format=torch.contiguous_format))


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward (Megatron's g): a partial sum
    made whole for code every rank runs alike (the residual stream, the
    loss), whose gradient is then the same whole value on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        return _summed(group, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward (Megatron's f): a replicated
    tensor entering rank-local code (a column-cut projection, a rank's
    experts or heads), whose gradient each rank holds a part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _summed(ctx.group, g), None


class _Sum(torch.autograd.Function):
    """All-reduce forward and backward: a total of the ranks' shares that
    each rank then reads for its own slice (the split gated norm's sum of
    squares), so each rank holds a part of its gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(group, x)

    @staticmethod
    def backward(ctx, g):
        return _summed(ctx.group, g), None


class _Gather(torch.autograd.Function):
    """All-gather forward; backward the rank's slice of the gradient summed
    over the ranks (each rank's consumers read the whole tensor for their
    own slice of the work)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return group.gather(x)

    @staticmethod
    def backward(ctx, g):
        r = ctx.group.tp_rank
        return _summed(ctx.group, g).narrow(-1, r * ctx.n, ctx.n), None


@dataclasses.dataclass
class TensorParallel:
    """A model's view of its group: the config of its local heads and which
    of its outputs are split over the model axis.

    The collectives carry their backward under autograd (a training
    forward; serving runs without grad and takes the in-place forms):
    `reduce` and `copy` are Megatron's pair, `sum` a total each rank reads
    its own share of, `gather` an all-gather whose backward is the rank's
    slice of the summed gradient. With `copy` where the replicated
    residual enters rank-local code and `reduce` where a partial sum
    leaves it, each rank's gradient of a cut leaf is its slice of the
    one-device gradient, and of a replicated leaf the whole of it."""
    group: ServingGroup
    cfg: ModelConfig            # the rank's local heads (`local_config`)
    mlp_split: bool             # w_gate / w_up / w_down cut on d_ff
    vocab_split: bool           # embed (and lm_head) cut on the vocab
    expert_split: bool = False  # the MoE's expert stacks cut on E
    shared_split: bool = False  # the MoE's shared expert cut on its d_ff
    hd_split: bool = False      # K/V cut on head_dim (the fallback)
    whole: Optional[ModelConfig] = None   # the model's config
    cut_leaves: frozenset = frozenset()   # the leaves cut over the group
    #: under the fallback: the query heads the rank's attention runs on
    #: (`head_span`), and whether the layout gathers q (`q_gathered`)
    heads: Tuple[int, int] = (0, 0)
    q_gather: bool = False

    def part(self, n: int) -> slice:
        """This rank's contiguous slice of n: its SSD heads or RG-LRU
        channels, or its experts where they are cut."""
        k = n // self.m
        return slice(self.rank * k, (self.rank + 1) * k)

    def experts(self, n: int) -> slice:
        """The experts of n that this rank applies: its contiguous slice
        of E when the stacks are cut on E, else all of them."""
        return self.part(n) if self.expert_split else slice(0, n)

    def kv_dim(self, hd: int) -> int:
        """The head_dim a rank's K/V cache stores: hd/m under the head_dim
        fallback, else the whole hd."""
        return hd // self.m if self.hd_split else hd

    @property
    def kv_heads(self) -> Tuple[int, int]:
        """Under the head_dim fallback, the kv-heads [k0, k1) the rank's
        query heads (`heads`) read: head h reads kv-head h // G."""
        G = self.whole.num_heads // self.whole.num_kv_heads
        return self.heads[0] // G, -(-self.heads[1] // G)

    def q_heads(self, q: torch.Tensor) -> torch.Tensor:
        """q (..., c) of the rank's `wq` columns -> (..., n, hd) of the
        heads its attention runs on: under the fallback, where the layout
        gathers q, the whole H·hd gathered over the group (one all-gather)
        and the rank's `heads` taken; else its columns are those heads."""
        hd = self.whole.resolved_head_dim
        if self.q_gather:
            h0, h1 = self.heads
            q = self.gather(q)[..., h0 * hd:h1 * hd]
        return q.unflatten(-1, (-1, hd))

    def out_cols(self, out: torch.Tensor) -> torch.Tensor:
        """The attention output (..., n·hd) of the rank's `heads` -> its
        flat columns of H·hd, the rows of `wo` it holds (the output itself
        where the layout does not gather q)."""
        if not self.q_gather:
            return out
        w = self.whole
        n = w.num_heads * w.resolved_head_dim // self.m
        at = self.rank * n - self.heads[0] * w.resolved_head_dim
        return out[..., at:at + n]

    def kv_span(self, k: torch.Tensor) -> torch.Tensor:
        """(..., KV, hd) K or V with every kv-head -> (..., k1 - k0, hd),
        the kv-heads the rank's query heads read (`kv_heads`), contiguous
        for the kernels."""
        k0, k1 = self.kv_heads
        return k[..., k0:k1, :].contiguous()

    @property
    def m(self) -> int:
        return self.group.model_size

    @property
    def rank(self) -> int:
        return self.group.tp_rank

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """A partial sum made whole on every rank."""
        if _grad(x):
            return _Reduce.apply(x, self.group)
        return self.group.all_reduce(x)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """x itself, whose gradient is summed over the group in a backward
        pass (the identity without grad)."""
        return _Copy.apply(x, self.group) if _grad(x) else x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' shares summed, for rank-local readers: as `reduce`,
        with the gradient summed over the group in a backward pass."""
        if _grad(x):
            return _Sum.apply(x, self.group)
        return self.group.all_reduce(x)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the group (no gradient)."""
        return self.group.all_reduce(x.detach().clone(), op="max")

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' slices of the last axis, whole on every rank
        (`ServingGroup.gather`)."""
        if _grad(x):
            return _Gather.apply(x, self.group)
        return self.group.gather(x)

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

    def norm_parts(self, name: str, t: torch.Tensor):
        """(part, cut) of the rank's leaf `name`: its slice of a leaf cut
        over the group, or a leaf every rank holds whole; mamba2's
        `in_proj` and `conv_*` by their segments (`segments`)."""
        segs = segments(name, self.whole)
        if segs is None:
            return [(t, name in self.cut_leaves)]
        parts, at = [], 0
        for width, cut in segs:
            n = width // self.m if cut else width
            parts.append((t.narrow(-1, at, n), cut and self.m > 1))
            at += n
        return parts


def tensor_parallel(cfg: ModelConfig, group: ServingGroup) -> TensorParallel:
    """`cfg`'s layout on `group`'s model axis (raises where the port
    serves no mesh: `check_tp`)."""
    m = group.model_size
    lcfg = local_config(cfg, m, group.tp_rank)
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
    cut = frozenset(name for name, t in named_leaves(init_params(
        cfg, device="meta")) if "model" in serve_spec(name, tuple(t.shape),
                                                     cfg, m))
    hd_split = bool(cfg.num_heads) and kv_head_axes(
        m, cfg.num_kv_heads, cfg.resolved_head_dim)[1] == "model"
    return TensorParallel(group, lcfg, mlp_split=mlp[1] == "model",
                          vocab_split=vocab[0] == "model",
                          expert_split="model" in experts[1:2],
                          shared_split="model" in shared[1:2],
                          hd_split=hd_split, whole=cfg, cut_leaves=cut,
                          heads=head_span(cfg, m, group.tp_rank)
                          if hd_split else (0, 0),
                          q_gather=q_gathered(cfg, m))


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
