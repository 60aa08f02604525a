"""Analytic step-latency model for the discrete-event simulator.

tau_step for a fused step = fixed scheduler overhead
                          + weight-read time (memory-bound floor)
                          + per-row marginal cost (KV read + decode FLOPs)
                          + prefill-chunk FLOPs (if PD fusion packs any)

This produces the paper's observed shape: D(b) ~ c0 + c1*b (linear, Fig 3)
and Phi(b) = b / tau(b) concave increasing. Hardware profiles cover the
paper's GPU-class deployments and the TPU v5e target; the `paper-fig3`
profile is calibrated so LLaMA3-70B matches Fig 3's anchor points
(b=100 -> ~50 ms, ~2000 tok/s; b=230 -> ~80 ms, ~2700 tok/s).
"""
from __future__ import annotations

import dataclasses

from repro_torch.config.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    chips: int
    flops_per_chip: float          # bf16 FLOP/s
    hbm_bw_per_chip: float         # B/s
    hbm_per_chip: float            # bytes
    step_overhead_ms: float = 15.0  # scheduler + launch + sampling
    # host-side share of step_overhead_ms (DESIGN §14): admission, lane
    # packing, block-table edits, sampling readback — the portion the async
    # dispatch-ahead loop can overlap with the in-flight device step. The
    # remainder of tau_step is device time. Must be <= step_overhead_ms.
    host_overhead_ms: float = 0.0
    parallel_eff: float = 0.85     # TP scaling efficiency
    # host<->device interconnect per chip (PCIe gen4 x16-class), the KV
    # swap path's bandwidth (DESIGN §11)
    pcie_bw_per_chip: float = 24e9


PROFILES = {
    "a100x8": HardwareProfile("a100x8", 8, 312e12, 2.039e12, 80e9,
                              step_overhead_ms=20.0, host_overhead_ms=8.0),
    "h800x8": HardwareProfile("h800x8", 8, 989e12, 3.35e12, 80e9,
                              step_overhead_ms=15.0, host_overhead_ms=6.0),
    "v5e-16": HardwareProfile("v5e-16", 16, 197e12, 819e9, 16e9,
                              step_overhead_ms=5.0, host_overhead_ms=2.0),
    "v5e-256": HardwareProfile("v5e-256", 256, 197e12, 819e9, 16e9,
                               step_overhead_ms=5.0, host_overhead_ms=2.0),
    # calibrated to the paper's Fig 3 anchors (LLaMA3-70B deployment)
    "paper-fig3": HardwareProfile("paper-fig3", 8, 120e12, 1.1e12, 64e9,
                                  step_overhead_ms=28.0,
                                  host_overhead_ms=10.0, parallel_eff=0.8),
}


@dataclasses.dataclass
class CostModel:
    cfg: ModelConfig
    hw: HardwareProfile
    dtype_bytes: int = 2
    # optional calibrated-linear override: tau = c0 + c1*(rows + prefill_toks).
    # Used by the paper-reproduction benchmarks where the paper's deployment
    # (vLLM-on-GPU, Fig 3) is flatter/steeper than the pure roofline law.
    c0_ms: float = 0.0
    c1_ms: float = 0.0

    def __post_init__(self):
        hwp = self.hw
        self.total_flops = hwp.chips * hwp.flops_per_chip * hwp.parallel_eff
        self.total_bw = hwp.chips * hwp.hbm_bw_per_chip * hwp.parallel_eff
        self.n_active = self.cfg.active_param_count()
        self.weight_bytes = self.n_active * self.dtype_bytes
        self.kv_bpt = self.cfg.kv_bytes_per_token(self.dtype_bytes)

    # -- components (seconds) ------------------------------------------------
    def weight_read_s(self) -> float:
        return self.weight_bytes / self.total_bw

    def decode_row_s(self, ctx_len: float) -> float:
        kv_read = ctx_len * self.kv_bpt / self.total_bw
        compute = 2.0 * self.n_active / self.total_flops
        return kv_read + compute

    def prefill_tokens_s(self, n_tokens: int, ctx_len: float) -> float:
        if n_tokens <= 0:
            return 0.0
        dense = 2.0 * self.n_active * n_tokens / self.total_flops
        # quadratic attention term (scores against ctx)
        att = 0.0
        if self.kv_bpt:
            att_flops = 4.0 * self.cfg.num_layers * self.cfg.d_model \
                * n_tokens * ctx_len
            att = att_flops / self.total_flops
        return dense + att

    # -- two-tier KV swap (DESIGN §11) ----------------------------------------
    def swap_bytes(self, n_blocks: int, block_size: int) -> int:
        """KV bytes held by n_blocks pool blocks (one direction's payload)."""
        return n_blocks * block_size * self.kv_bpt

    def pcie_s(self, n_blocks: int, block_size: int) -> float:
        """One-way host<->device transfer time for n_blocks KV blocks."""
        bw = self.hw.chips * self.hw.pcie_bw_per_chip
        return self.swap_bytes(n_blocks, block_size) / bw

    def reprefill_s(self, context_tokens: int) -> float:
        """Time to rebuild a victim's KV from scratch: a full re-prefill of
        its context (mean attention depth ~ context/2)."""
        return self.prefill_tokens_s(context_tokens, context_tokens / 2.0)

    def swap_beats_recompute(self, n_blocks: int, block_size: int,
                             context_tokens: int) -> bool:
        """The preemption crossover (DESIGN §11): swap the victim when the
        round-trip PCIe time for its blocks undercuts re-prefilling its
        context — trade interconnect bandwidth for re-prefill FLOPs."""
        if self.kv_bpt == 0:
            return False
        return 2.0 * self.pcie_s(n_blocks, block_size) \
            < self.reprefill_s(context_tokens)

    # -- the step law ---------------------------------------------------------
    def tau_step_s(self, decode_batch: int, mean_ctx: float,
                   prefill_tokens: int = 0, prefill_ctx: float = 0.0) -> float:
        if self.c1_ms:
            return (self.c0_ms + self.c1_ms *
                    (decode_batch + prefill_tokens)) / 1e3
        t = self.hw.step_overhead_ms / 1e3
        t += self.weight_read_s()
        t += decode_batch * self.decode_row_s(mean_ctx)
        t += self.prefill_tokens_s(prefill_tokens, prefill_ctx or mean_ctx)
        return t

    def split_host_device(self, tau_s: float) -> "tuple[float, float]":
        """Split one interval's tau_step into (host_s, device_s) — the
        host-vs-device interval split (DESIGN §14). Host time is the
        profile's host_overhead_ms share of the fixed step overhead
        (clamped to the interval: a tiny calibrated tau can undercut it);
        everything else — weight reads, KV reads, FLOPs — is device time.
        host_s + device_s == tau_s always, so the sync-mode clock is
        unchanged; the async sim advances by max(host, device) instead."""
        host = min(self.hw.host_overhead_ms / 1e3, tau_s)
        return host, tau_s - host

    def tau_step_ms(self, decode_batch: int, mean_ctx: float,
                    prefill_tokens: int = 0, prefill_ctx: float = 0.0) -> float:
        return 1e3 * self.tau_step_s(decode_batch, mean_ctx, prefill_tokens,
                                     prefill_ctx)

    # -- memory budget ---------------------------------------------------------
    def kv_pool_bytes(self, activation_frac: float = 0.1) -> int:
        total = self.hw.chips * self.hw.hbm_per_chip
        params = self.cfg.param_count() * self.dtype_bytes
        budget = total * (1 - activation_frac) - params
        return max(int(budget), 0)
