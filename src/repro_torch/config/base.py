"""Config dataclasses for the PyTorch port: the port's own copy of the
JAX package's `config/base.py`, field for field, so the two packages read
the same configurations without the port importing the JAX package.

Everything is a frozen dataclass so configs hash/compare cleanly.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class ArchFamily(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"      # RG-LRU + local attention (RecurrentGemma)
    ENCDEC = "encdec"      # audio/enc-dec backbone (Seamless M4T)
    VLM = "vlm"            # decoder + cross-attn image layers


class AttentionKind(str, enum.Enum):
    FULL = "full"                  # causal full attention
    SLIDING = "sliding"            # sliding-window causal attention
    LOCAL_HYBRID = "local_hybrid"  # RecurrentGemma local attention (in hybrid blocks)
    NONE = "none"                  # attention-free (pure SSM)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_tok: int
    num_shared_experts: int = 0
    expert_ff_dim: int = 0          # d_ff of each routed expert
    shared_ff_dim: int = 0          # d_ff of the shared expert block (total)
    router_aux_loss_coef: float = 0.001
    capacity_factor: float = 1.25   # dense-dispatch capacity per expert
    # serving-path dispatch: True = exact worst-case capacity (bitwise
    # chunking-invariant — CPU engine/tests); False = capacity_factor
    # dispatch (production TPU: bounds the (G,E,C) tensors; §Perf iter G)
    inference_no_drop: bool = True


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128            # N (SSD state size)
    head_dim: int = 64              # P (channels per SSD head)
    num_heads: int = 0              # derived: d_inner / head_dim if 0
    conv_width: int = 4
    chunk_size: int = 256           # SSD chunked-scan block length
    expand: int = 2                 # d_inner = expand * d_model


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma recurrent block (RG-LRU)."""
    lru_width: int = 0              # defaults to d_model if 0
    conv_width: int = 4
    window_size: int = 2048         # local-attention window of the hybrid attn blocks
    block_pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: ArchFamily
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # derived d_model // num_heads if 0
    attention: AttentionKind = AttentionKind.FULL
    sliding_window: int = 0         # >0 for AttentionKind.SLIDING
    qkv_bias: bool = False          # Qwen-style attention bias
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # enc-dec (audio backbone)
    encoder_layers: int = 0
    # VLM: 1 cross-attn layer inserted every `vlm_cross_every` decoder layers
    vlm_cross_every: int = 0
    num_cross_layers: int = 0
    dtype: str = "bfloat16"
    source: str = ""                # citation for the config

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if not self.num_heads:
            return 0
        return self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.attention == AttentionKind.NONE

    def param_count(self) -> int:
        """Total parameter count (approximate, matches the builder's tensors)."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        h = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        n = emb
        # Attention-bearing layers
        att = (self.num_heads * h + 2 * self.num_kv_heads * h) * d \
            + self.num_heads * h * d
        mlp = 3 * d * f  # SwiGLU
        if self.family in (ArchFamily.DENSE, ArchFamily.VLM):
            n += self.num_layers * (att + mlp + 2 * d)
            if self.family == ArchFamily.VLM and self.num_cross_layers:
                n += self.num_cross_layers * (att + mlp + 2 * d)
        elif self.family == ArchFamily.MOE:
            m = self.moe
            routed = 3 * d * m.expert_ff_dim * m.num_experts
            shared = 3 * d * m.shared_ff_dim if m.shared_ff_dim else 0
            router = d * m.num_experts
            n += self.num_layers * (att + routed + shared + router + 2 * d)
        elif self.family == ArchFamily.SSM:
            s = self.ssm
            d_in = s.expand * d
            nheads = s.num_heads or d_in // s.head_dim
            per = d * (2 * d_in + 2 * nheads * s.state_dim if False else 0)
            # mamba2: in_proj d->(2*d_in + 2*n_groups*N + nheads), out_proj d_in->d
            per = d * (2 * d_in + 2 * s.state_dim + nheads) + d_in * d \
                + s.conv_width * (d_in + 2 * s.state_dim) + d_in + 2 * nheads
            n += self.num_layers * (per + d)
        elif self.family == ArchFamily.HYBRID:
            r = self.rglru
            w = r.lru_width or d
            rec = d * (2 * w) + w * d + r.conv_width * w + 3 * w  # proj + conv + gates(diag-ish)
            rec = 2 * d * w + w * d + r.conv_width * w + 2 * w * w + 2 * w
            pat = r.block_pattern
            n_att = sum(1 for p in self.layer_kinds() if p == "attention")
            n_rec = self.num_layers - n_att
            n += n_att * (att + mlp + 2 * d) + n_rec * (rec + mlp + 2 * d)
        elif self.family == ArchFamily.ENCDEC:
            # encoder: self-att + mlp; decoder: self + cross + mlp
            n += self.encoder_layers * (att + mlp + 2 * d)
            n += self.num_layers * (2 * att + mlp + 3 * d)
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top-k experts only)."""
        if self.family != ArchFamily.MOE:
            return self.param_count()
        d = self.d_model
        m = self.moe
        h = self.resolved_head_dim
        att = (self.num_heads * h + 2 * self.num_kv_heads * h) * d \
            + self.num_heads * h * d
        routed_active = 3 * d * m.expert_ff_dim * m.num_experts_per_tok
        shared = 3 * d * m.shared_ff_dim if m.shared_ff_dim else 0
        router = d * m.num_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return emb + self.num_layers * (att + routed_active + shared + router + 2 * d) + d

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind sequence ('attention'|'recurrent'|'ssm'|'dense'|'cross')."""
        if self.family == ArchFamily.HYBRID:
            pat = self.rglru.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        if self.family == ArchFamily.SSM:
            return tuple("ssm" for _ in range(self.num_layers))
        return tuple("attention" for _ in range(self.num_layers))

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """KV-cache bytes per token per request — the scheduler's memory model.

        For bounded/constant-state families this is the *asymptotic marginal*
        cost (0 for SSM; window-capped handled in core.memory_model).
        """
        h = self.resolved_head_dim
        if self.family == ArchFamily.SSM:
            return 0
        n_att = sum(1 for k in self.layer_kinds() if k == "attention")
        layers = n_att if self.family == ArchFamily.HYBRID else self.num_layers
        if self.family == ArchFamily.ENCDEC:
            layers = self.num_layers  # decoder self-attn only grows
        return 2 * layers * self.num_kv_heads * h * dtype_bytes


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving engine + scheduler configuration (paper's knobs)."""
    policy: str = "combined"       # static | memory | sla | combined
    b_min: int = 1                 # B_min
    b_max: int = 256               # B_max (static policy uses this as THE batch size)
    d_sla_ms: float = 0.0          # D_SLA; 0 => no SLA constraint
    eps_d_ms: float = 2.0          # ε_D latency tolerance band
    # per-request goodput SLOs (DESIGN §15), distinct from the per-step
    # controller SLA d_sla_ms: a finished request meets the SLA iff its
    # TTFT <= ttft_sla_s AND its mean TBT <= tbt_sla_ms; goodput counts
    # only SLA-met requests' tokens. 0 disables that check (every
    # finished request then passes it). Verdicts stamp at retirement in
    # the engine and at finish in the sim (rejected requests never meet).
    ttft_sla_s: float = 0.0
    tbt_sla_ms: float = 0.0
    eps_m: float = 0.05            # ε_M memory-overflow probability budget
    alpha: int = 16                # Alg 2 window-width control α
    delta: int = 4                 # Alg 2 anti-noise relaxation δ
    block_size: int = 16           # KV allocator block granularity (tokens)
    # physically paged KV cache (DESIGN §9): K/V live in shared
    # (layers, num_blocks, block_size, KV, hd) pools indexed by the
    # BlockManager's per-request block tables; lane promotion, finish
    # compaction and eviction become O(1) table edits. False keeps the
    # legacy contiguous per-slot cache (n_prefill_lanes=1 bit-for-bit).
    paged_kv: bool = False
    # ref-counted automatic prefix sharing on the paged pool (DESIGN §10):
    # per-block refcounts + content-hash index; admission maps shared full
    # prompt blocks with zero copies and prefills only the suffix; free()
    # becomes decref with blocks held as evictable LRU cache. Requires
    # paged_kv and an attention-only family (gated per-engine).
    prefix_cache: bool = False
    kv_pool_tokens: int = 0        # η; 0 => derived from memory budget
    hbm_budget_bytes: int = 0      # M_max source; 0 => engine-provided
    l0_refresh_interval: int = 32  # L0 offline refresh cadence (intervals)
    chunked_prefill: bool = False  # PD-fusion mode
    chunk_budget_tokens: int = 512 # base token budget per fused step
    # PD-fusion lanes (DESIGN §6): spare physical cache rows past the decode
    # buckets; each lane chunk-prefills one request per interval, the
    # interval's chunk_budget is packed across occupied lanes
    n_prefill_lanes: int = 1
    # lane packer policy: "fifo" (arrival order — 1 lane reproduces the
    # single-spare-row engine bit-for-bit) | "srf" (shortest remaining first)
    prefill_pack: str = "fifo"
    max_new_tokens: int = 128
    batch_buckets: Tuple[int, ...] = ()  # () => exact batch (CPU), else bucketized
    # two-tier KV memory (DESIGN §11): a host-side swap pool of this many
    # blocks. 0 (default) keeps today's recompute-only preemption; > 0 lets
    # the preemption path choose per-victim between swapping the victim's
    # blocks to host RAM (kept as a swap ledger, restored on re-admission)
    # and recompute, using the cost-model crossover
    # pcie_ms(blocks) < reprefill_ms(context). Requires paged_kv in the
    # engine; attention-only families (shared gate with prefix_cache).
    swap_space_blocks: int = 0
    # preemption flavor when the pool would overflow: "recompute" throws
    # the victim's KV away (vLLM recompute; the only choice when
    # swap_space_blocks == 0), "auto" applies the DESIGN §11 cost-model
    # crossover per victim, "swap" forces swap-out whenever it is possible
    # at all (host space, no shared blocks — else recompute fallback)
    preempt: str = "auto"
    # async dispatch-ahead pipeline (DESIGN §14): how many device steps may
    # be in flight while the host schedules the next interval. 0 keeps the
    # fully synchronous loop (dispatch + retire inside one interval); 1
    # overlaps interval N+1's admission/lane-packing/table edits with
    # interval N's device step, reading telemetry one interval late (Alg 1
    # tolerates stale snapshots by design). Outputs are bitwise-identical
    # at every depth — only wall-clock attribution changes.
    overlap_depth: int = 0
    # mesh-sharded serving (DESIGN §12): device mesh shape for the engine,
    # last axis = "model" (tensor parallelism over kv-heads / head_dim),
    # leading axes = ("data",) or ("pod", "data"). () keeps today's
    # single-device engine. Under a mesh, hbm_budget_bytes / kv_pool_tokens
    # are PER-CHIP quantities: the pool's token capacity scales with the
    # model-axis size (each chip holds 1/m of every token's KV bytes).
    mesh_shape: Tuple[int, ...] = ()

    @property
    def model_axis_size(self) -> int:
        """Size of the mesh's "model" (tensor-parallel) axis — by
        convention the LAST axis of mesh_shape (DESIGN §5/§12)."""
        return self.mesh_shape[-1] if self.mesh_shape else 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 8
    seq_len: int = 256
    steps: int = 200
    lr: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    seed: int = 0
    log_every: int = 10
    remat: bool = True
