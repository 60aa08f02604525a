"""Memory model for the scheduler: the paper's CLT chance-constraint math
(DESIGN §2).

Maps GPU/TPU HBM budget -> token capacity eta, and implements

    mu_S    = b (E[l_in] + E[l_out])                       (8)
    sigma_S = sqrt(b (Var(l_in) + Var(l_out)))             (9)
    P(S > eta) ~ 1 - Phi((eta - mu_S) / sigma_S) <= eps_M  (10)/(11)
    b_max^mem closed form                                   (12)
    L0 = eta - (theta * sigma_S + mu_S);  b <= (eta - L0)/E[l]  (13)/(14)

Per-architecture adaptation (DESIGN §4): the token cost and the *effective*
length moments depend on the family — sliding windows truncate lengths,
SSM state is constant per request (the constraint degenerates to a request
cap), enc-dec/VLM add a fixed per-request cross-KV term.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.models import backbone as bb


def norm_ppf(q: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation).

    |relative error| < 1.15e-9 over (0, 1); no scipy dependency.
    """
    if not 0.0 < q < 1.0:
        raise ValueError(f"q must be in (0,1), got {q}")
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if q < plow:
        u = math.sqrt(-2 * math.log(q))
        return (((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u + c[5]) / \
            ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1)
    if q > phigh:
        return -norm_ppf(1 - q)
    u = q - 0.5
    t = u * u
    return (((((a[0] * t + a[1]) * t + a[2]) * t + a[3]) * t + a[4]) * t + a[5]) * u / \
        (((((b[0] * t + b[1]) * t + b[2]) * t + b[3]) * t + b[4]) * t + 1)


def norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def kv_shard_factor(cfg: ModelConfig, model_axis: int) -> int:
    """Effective model-parallel shard count of the serving KV pool
    (DESIGN §12).

    The pool shards over the "model" axis on kv-heads, falling back to
    head_dim when kv-heads don't divide (the DESIGN §5 cache rule).
    Returns 1 — pool unsharded, capacity does not scale — when the axis
    is trivial, the family is attention-free (no token pool to shard), or
    neither kv-heads nor head_dim divides the axis. Pure Python so the
    simulator twin can apply the identical rule without touching jax."""
    if model_axis <= 1:
        return 1
    if cfg.kv_bytes_per_token() == 0:
        return 1
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if kv % model_axis == 0 or hd % model_axis == 0:
        return model_axis
    return 1


@dataclasses.dataclass
class MemoryModel:
    """Token-capacity accounting for one architecture on one device budget.

    Chip-aware under mesh-sharded serving (DESIGN §12): `hbm_budget_bytes`
    and `eta_tokens` are PER-CHIP quantities, and `model_shards` (the
    effective model-axis shard count, see `kv_shard_factor`) scales the
    pool — each chip holds 1/m of every token's KV bytes, so the same
    per-chip HBM backs m× the tokens. `model_shards = 1` (default) keeps
    the legacy single-device accounting byte-for-byte."""

    cfg: ModelConfig
    hbm_budget_bytes: int            # M_max per chip: free HBM after params+activations
    eps_m: float = 0.05
    kv_dtype_bytes: int = 2
    block_size: int = 16             # allocator granularity (vLLM-style blocks)
    eta_tokens: int = 0              # explicit per-chip token-pool override (engine)
    model_shards: int = 1            # model-axis shards of the KV pool (DESIGN §12)

    def __post_init__(self):
        self.theta = norm_ppf(1.0 - self.eps_m)
        self._bpt = self.cfg.kv_bytes_per_token(self.kv_dtype_bytes)

    # -- capacity ---------------------------------------------------------
    @property
    def bytes_per_token(self) -> int:
        return self._bpt

    def fixed_bytes_per_request(self, enc_len: int = 0) -> int:
        """Per-request state independent of generated length (SSM state,
        conv state, cross-KV, window-capped KV)."""
        cfg = self.cfg
        if cfg.family == ArchFamily.SSM:
            return bb.cache_bytes(cfg, 1, 1)
        extra = 0
        if cfg.family in (ArchFamily.ENCDEC, ArchFamily.VLM) and enc_len:
            hd = cfg.resolved_head_dim
            n_cross = (cfg.num_layers if cfg.family == ArchFamily.ENCDEC
                       else cfg.num_cross_layers)
            extra = 2 * n_cross * enc_len * cfg.num_kv_heads * hd * self.kv_dtype_bytes
        if cfg.family == ArchFamily.HYBRID:
            # recurrent + conv state
            w = cfg.rglru.lru_width or cfg.d_model
            kinds = cfg.layer_kinds()
            n_rec = sum(1 for k in kinds if k == "recurrent")
            extra += n_rec * (w * 4 + (cfg.rglru.conv_width - 1) * w * self.kv_dtype_bytes)
        return extra

    @property
    def eta(self) -> int:
        """Max concurrent tokens in the KV pool (eq. context, block-rounded).

        Scales with `model_shards`: per-chip budget × shards worth of
        tokens fit when each token's KV is split over the model axis
        (DESIGN §12)."""
        if self.eta_tokens:
            tokens = self.eta_tokens * self.model_shards
            return (tokens // self.block_size) * self.block_size
        if self._bpt == 0:
            return 0
        tokens = self.hbm_budget_bytes * self.model_shards // self._bpt
        return (tokens // self.block_size) * self.block_size

    @property
    def num_blocks(self) -> int:
        """Physical pool blocks for the paged KV cache: the allocator's
        block count IS the pool's leading dimension (DESIGN §9)."""
        return self.eta // self.block_size

    def tokens_to_bytes(self, tokens: int) -> int:
        """Usage-reporting helper (DESIGN §10): the BlockManager's logical
        (per-request) vs physical (deduped) token counts expressed in HBM
        bytes, so operators see what prefix sharing actually saves."""
        return tokens * self._bpt

    def blocks_to_bytes(self, n_blocks: int) -> int:
        """KV payload bytes held by n_blocks allocator blocks — the unit
        the swap counters charge per transferred block in BOTH engine and
        sim, so the twins' byte telemetry stays comparable (DESIGN §11)."""
        return n_blocks * self.block_size * self._bpt

    def max_requests_state_only(self) -> int:
        """SSM-style cap: requests whose state fits the budget."""
        per = self.fixed_bytes_per_request()
        return max(1, self.hbm_budget_bytes // max(per, 1))

    # -- effective length moments (family-aware truncation) ----------------
    def effective_moments(self, mean_in: float, var_in: float,
                          mean_out: float, var_out: float):
        """Per-request token-footprint moments. Window-attention families
        cap the footprint at the window size (ring buffer)."""
        cfg = self.cfg
        w = 0
        if cfg.attention == AttentionKind.SLIDING:
            w = cfg.sliding_window
        elif cfg.attention == AttentionKind.LOCAL_HYBRID:
            w = cfg.rglru.window_size
        mu = mean_in + mean_out
        var = var_in + var_out
        if w and mu > w:
            # footprint = min(l, w): approximate truncation — mean capped at
            # w, variance shrinks toward 0 as mass concentrates at the cap
            frac = w / mu
            mu = w
            var = var * frac * frac
        return mu, max(var, 0.0)

    # -- the paper's equations ---------------------------------------------
    def mu_sigma(self, b: int, mu_l: float, var_l: float):
        mu_s = b * mu_l                           # (8)
        sigma_s = math.sqrt(max(b * var_l, 0.0))  # (9)
        return mu_s, sigma_s

    def overflow_prob(self, b: int, mu_l: float, var_l: float) -> float:
        """P(S > eta) via the CLT normal approximation (10)."""
        if self._bpt == 0:
            return 0.0 if b <= self.max_requests_state_only() else 1.0
        mu_s, sigma_s = self.mu_sigma(b, mu_l, var_l)
        if sigma_s == 0.0:
            return 0.0 if mu_s <= self.eta else 1.0
        return 1.0 - norm_cdf((self.eta - mu_s) / sigma_s)

    def b_mem_closed_form(self, mu_l: float, var_l: float) -> int:
        """Eq. (12): largest b with P(S > eta) <= eps_M (future-work exact
        form; kept for tests & ablation)."""
        if self._bpt == 0:
            return self.max_requests_state_only()
        if mu_l <= 0:
            return 1
        sig1 = math.sqrt(max(var_l, 0.0))           # sigma_S at b=1
        th = self.theta * sig1
        disc = th * th + 4 * mu_l * self.eta
        root = (math.sqrt(disc) - th) / (2 * mu_l)  # sqrt(b) from the quadratic
        return max(int(root * root), 1)

    def safety_buffer_L0(self, b: int, mu_l: float, var_l: float) -> float:
        """L0 = eta - (theta*sigma_S + mu_S), evaluated at batch size b."""
        mu_s, sigma_s = self.mu_sigma(b, mu_l, var_l)
        return self.eta - (self.theta * sigma_s + mu_s)

    def b_mem_linear(self, L0: float, mu_l: float) -> int:
        """Eq. (14): b <= (eta - L0) / E[l] — the online linear rule."""
        if self._bpt == 0:
            return self.max_requests_state_only()
        if mu_l <= 0:
            return 1
        return max(int((self.eta - L0) // mu_l), 1)
