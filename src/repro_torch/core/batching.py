"""The paper's two dynamic batching algorithms + the combined policy.

Algorithm 1 (BatchingMemory)  — memory-constrained dynamic batching, eq. (14)
Algorithm 2 (BatchingSLA)     — SLA-constrained noisy binary search on b_t
Combined                      — b* = min(b_mem, b_SLA)            (paper §III-B)
Static                        — vLLM-style fixed max batch (the baseline)

Every policy is a pure-Python controller called once per scheduling interval
with a TelemetrySnapshot; it returns a BatchDecision (the middle layer of the
controller stack, DESIGN §1). The engine/simulator enforces the decision:
admission control against the block pool, plus — in PD-fusion mode — the
chunked-prefill token budget packed across prefill lanes (DESIGN §6).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.config.base import ServeConfig
from repro_torch.core.memory_model import MemoryModel
from repro_torch.core.telemetry import TelemetrySnapshot


@dataclasses.dataclass
class BatchDecision:
    """One scheduling interval's output: b_t plus the PD-fusion token budget
    the packer may spend on prefill chunks (DESIGN §1, §6)."""
    max_batch: int                   # b_t: concurrent-request cap this interval
    chunk_budget: int = 0            # PD-fusion token budget (0 = no fusion)
    b_mem: int = 0                   # diagnostics
    b_sla: int = 0


class Policy:
    """Controller interface (DESIGN §1): TelemetrySnapshot -> BatchDecision,
    once per scheduling interval. Stateful subclasses implement the paper's
    Algorithms 1 & 2."""

    name = "base"

    def step(self, tel: TelemetrySnapshot) -> BatchDecision:
        raise NotImplementedError


class StaticPolicy(Policy):
    """vLLM baseline: a fixed preset max batch size (max_num_seqs) — the
    paper's static-batching comparison row (Table I; DESIGN §1)."""

    name = "static"

    def __init__(self, cfg: ServeConfig):
        self.cfg = cfg

    def step(self, tel: TelemetrySnapshot) -> BatchDecision:
        return BatchDecision(max_batch=self.cfg.b_max,
                             chunk_budget=self.cfg.chunk_budget_tokens
                             if self.cfg.chunked_prefill else 0)


class BatchingMemory(Policy):
    """Paper Algorithm 1 — memory-constrained dynamic batching (DESIGN §2).

    L0 <- eta - (theta * sigma_S + mu_S)          (line 1; refreshed periodically)
    b_t <- b_{t-1}
    if N^d > 0 and N^p > 0:
        b_t <- floor((eta - L0) / (E[l_in] + E[l_out]))   (eq. 14)
    b_t <- min(max(b_t, N^d), B_max)

    The L0 refresh uses the rigorous closed form (12) — see `_refresh_L0`
    and DESIGN §2.3 for why the paper's printed residual is replaced.
    """

    name = "memory"

    def __init__(self, cfg: ServeConfig, mem: MemoryModel):
        self.cfg = cfg
        self.mem = mem
        self.b_prev = cfg.b_max
        self.L0: Optional[float] = None
        self._ticks = 0

    def _refresh_L0(self, tel: TelemetrySnapshot):
        """L0 refresh (Alg 1 line 1).

        The paper's printed L0 = eta - (theta*sigma_S + mu_S) is a feedback
        residual that goes negative (and over-admits) when the reference
        batch exceeds capacity; the paper lists replacing it with the
        rigorous form (12) as future work (§IV). We implement that form:
        L0 = theta * sigma_S(b*) with b* from the closed-form (12), which
        makes the online linear rule (14) exact: (eta - L0)/E[l] = b*.
        """
        mu_l, var_l = self.mem.effective_moments(
            tel.mean_in, tel.var_in, tel.mean_out, tel.var_out)
        if mu_l <= 0:
            return
        b_star = self.mem.b_mem_closed_form(mu_l, var_l)
        self.L0 = max(self.mem.theta * math.sqrt(max(b_star * var_l, 0.0)),
                      0.0)

    def step(self, tel: TelemetrySnapshot) -> BatchDecision:
        if self.L0 is None or self._ticks % self.cfg.l0_refresh_interval == 0:
            self._refresh_L0(tel)
        self._ticks += 1

        b_t = self.b_prev
        mu_l, _ = self.mem.effective_moments(
            tel.mean_in, tel.var_in, tel.mean_out, tel.var_out)
        if tel.n_decode_running > 0 and tel.n_prefill_waiting > 0 \
                and self.L0 is not None and mu_l > 0:
            # swap pressure (DESIGN §11): the swapped-out backlog holds a
            # claim on eta — treat its tokens as part of the safety buffer
            # so (eta - L0 - swapped)/E[l] caps admission accordingly
            b_t = self.mem.b_mem_linear(self.L0 + tel.swapped_tokens, mu_l)
        b_t = min(max(b_t, tel.n_decode_running), self.cfg.b_max)
        b_t = max(b_t, self.cfg.b_min)
        self.b_prev = b_t
        return BatchDecision(max_batch=b_t, b_mem=b_t,
                             chunk_budget=self._chunk_budget(b_t, tel))

    def _chunk_budget(self, b_t: int, tel: TelemetrySnapshot) -> int:
        if not self.cfg.chunked_prefill:
            return 0
        # PD fusion: the controller's b_t is a per-step token budget; decode
        # requests consume 1 token each, the remainder goes to prefill chunks
        return max(b_t - tel.n_decode_running, 0)


class BatchingSLA(Policy):
    """Paper Algorithm 2 — SLA-constrained noisy binary search (DESIGN §1.2).

    Maintains [b_low, b_high]; compares recent mean TBT tau-bar against
    D_SLA +/- eps_D and narrows/recenters the window; emits the midpoint.
    alpha controls the window width, delta relaxes against noise.
    """

    name = "sla"

    def __init__(self, cfg: ServeConfig):
        assert cfg.d_sla_ms > 0, "BatchingSLA requires d_sla_ms"
        self.cfg = cfg
        self.b_low = cfg.b_min
        self.b_high = cfg.b_max

    def step(self, tel: TelemetrySnapshot) -> BatchDecision:
        c = self.cfg
        tau = tel.tbt_ms
        b_bar = int(round(tel.mean_batch)) or self.b_low
        if tel.tbt_samples <= 0:
            # cold start: an empty TBT window reads as tau = 0.0, which the
            # headroom branch would take as "under SLA" every interval,
            # ratcheting the window to b_max before a single decode step has
            # been measured. Hold the window and emit the midpoint until
            # at least one on_decode_step sample exists.
            b_t = (self.b_low + self.b_high) // 2
            b_t = min(max(b_t, tel.n_decode_running), c.b_max)
            b_t = max(b_t, c.b_min)
            return BatchDecision(max_batch=b_t, b_sla=b_t,
                                 chunk_budget=self._chunk_budget(b_t, tel))
        if tau > c.d_sla_ms + c.eps_d_ms:
            # too slow: clamp the ceiling down to the observed batch
            self.b_high = max(b_bar, self.b_low + c.alpha)
            self.b_low = max(self.b_low - c.delta, c.b_min)
        elif tau < c.d_sla_ms - c.eps_d_ms:
            # headroom: raise the floor toward the observed batch
            self.b_low = min(b_bar, self.b_high - c.alpha)
            self.b_high = min(self.b_high + c.delta, c.b_max)
        else:
            # in band: tighten the window around the observed batch
            self.b_high = min(b_bar + c.alpha // 2, c.b_max)
            self.b_low = max(b_bar - c.alpha // 2, c.b_min)
        self.b_low = max(min(self.b_low, self.b_high), c.b_min)
        self.b_high = min(max(self.b_high, self.b_low), c.b_max)
        b_t = (self.b_low + self.b_high) // 2
        b_t = min(max(b_t, tel.n_decode_running), c.b_max)
        b_t = max(b_t, c.b_min)
        return BatchDecision(max_batch=b_t, b_sla=b_t,
                             chunk_budget=self._chunk_budget(b_t, tel))

    def _chunk_budget(self, b_t: int, tel: TelemetrySnapshot) -> int:
        if not self.cfg.chunked_prefill:
            return 0
        return max(b_t - tel.n_decode_running, 0)


class CombinedPolicy(Policy):
    """b* = min(b_mem, b_SLA) — the paper's full method (§III-B; DESIGN
    §1.2). In PD-fusion mode the fused chunk budget is likewise the min of
    the two policies' budgets."""

    name = "combined"

    def __init__(self, cfg: ServeConfig, mem: MemoryModel):
        self.memory = BatchingMemory(cfg, mem)
        self.sla = BatchingSLA(cfg) if cfg.d_sla_ms > 0 else None
        self.cfg = cfg

    def step(self, tel: TelemetrySnapshot) -> BatchDecision:
        dm = self.memory.step(tel)
        if self.sla is None:
            return dm
        ds = self.sla.step(tel)
        b = min(dm.max_batch, ds.max_batch)
        b = min(max(b, tel.n_decode_running, self.cfg.b_min), self.cfg.b_max)
        chunk = min(dm.chunk_budget, ds.chunk_budget) \
            if self.cfg.chunked_prefill else 0
        return BatchDecision(max_batch=b, chunk_budget=chunk,
                             b_mem=dm.max_batch, b_sla=ds.max_batch)


def bucketize(b: int, buckets) -> int:
    """Round b DOWN to the nearest compiled bucket (TPU static shapes,
    DESIGN §3); never below the smallest bucket."""
    if not buckets:
        return b
    le = [x for x in buckets if x <= b]
    return max(le) if le else min(buckets)


def make_policy(cfg: ServeConfig, mem: MemoryModel) -> Policy:
    if cfg.policy == "static":
        return StaticPolicy(cfg)
    if cfg.policy == "memory":
        return BatchingMemory(cfg, mem)
    if cfg.policy == "sla":
        return BatchingSLA(cfg)
    if cfg.policy == "combined":
        return CombinedPolicy(cfg, mem)
    raise ValueError(f"unknown policy {cfg.policy!r}")
