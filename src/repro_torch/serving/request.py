"""Request lifecycle for the serving engine & simulator."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class RequestState(enum.Enum):
    WAITING = "waiting"        # queued, no KV allocated
    PREFILLING = "prefilling"  # chunked prefill in progress
    RUNNING = "running"        # decoding
    PREEMPTED = "preempted"    # evicted; will re-prefill (recompute policy)
    SWAPPED = "swapped"        # KV offloaded to the host pool (DESIGN §11)
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    rid: int
    arrival_time: float
    prompt_tokens: Optional[List[int]] = None   # real engine
    prompt_len: int = 0                          # simulator (len only)
    max_new_tokens: int = 128
    true_output_len: int = 0                     # simulator: sampled a priori

    state: RequestState = RequestState.WAITING
    # set when admission drops the request as unservable (bigger than the
    # pool minus the watermark, or than the block-table width — DESIGN §9);
    # state is FINISHED with no output, this flag tells the two apart
    rejected: bool = False
    prefill_pos: int = 0                         # chunked-prefill progress
    # prefix sharing (DESIGN §10): prompt tokens served from shared blocks
    # at admission — prefill starts at this offset and only the suffix is
    # charged to the chunk budget
    cached_prefix_len: int = 0
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1                               # engine batch slot
    lane: int = -1                               # PD-fusion prefill lane (DESIGN §6)
    prefill_start_time: float = -1.0             # first prefill chunk (TTFT attribution)
    first_token_time: float = -1.0
    finish_time: float = -1.0
    tbt_samples: List[float] = dataclasses.field(default_factory=list)
    # two-tier swap (DESIGN §11): per-request swap latency accounting
    swap_out_time: float = -1.0                  # pending swap-out timestamp
    swapped_s: float = 0.0                       # total time spent offloaded
    n_swaps: int = 0                             # completed swap round trips
    # per-request goodput SLA verdict (DESIGN §15): stamped once — at
    # retirement in the engine, at finish/rejection in the sim — distinct
    # from the per-step `sla_attainment` window of d_sla_ms
    ttft_ok: bool = False
    tbt_ok: bool = False
    sla_met: bool = False

    def __post_init__(self):
        if self.prompt_tokens is not None and self.prompt_len == 0:
            self.prompt_len = len(self.prompt_tokens)

    @property
    def output_len(self) -> int:
        return len(self.output_tokens) if self.output_tokens else self._sim_outlen

    _sim_outlen: int = 0

    @property
    def context_len(self) -> int:
        return self.prompt_len + max(len(self.output_tokens), self._sim_outlen)

    def sim_emit_token(self):
        self._sim_outlen += 1

    def sim_reset_output(self):
        """Recompute preemption (simulator): the engine regenerates the
        victim's output from scratch on re-admission, so the sim twin
        drops the emitted count to mirror it step-for-step (DESIGN §11)."""
        self._sim_outlen = 0

    def stamp_sla(self, ttft_sla_s: float, tbt_sla_ms: float) -> bool:
        """Stamp the per-request goodput verdict (DESIGN §15).

        TTFT = first_token_time - arrival_time; mean TBT = the decode
        span (finish - first token) over the n-1 inter-token gaps (0 when
        at most one token was produced). A threshold of 0 disables that
        check; rejected (or never-served) requests never meet the SLA.
        Both twins compute the verdict from the same three timestamps, so
        the differential harness can compare them request for request."""
        if self.rejected or self.first_token_time < 0:
            self.ttft_ok = self.tbt_ok = self.sla_met = False
            return False
        ttft = self.first_token_time - self.arrival_time
        self.ttft_ok = ttft_sla_s <= 0 or ttft <= ttft_sla_s
        n_out = max(len(self.output_tokens), self._sim_outlen)
        tbt_ms = 0.0
        if n_out > 1 and self.finish_time >= 0:
            tbt_ms = (self.finish_time - self.first_token_time) \
                / (n_out - 1) * 1e3
        self.tbt_ok = tbt_sla_ms <= 0 or tbt_ms <= tbt_sla_ms
        self.sla_met = self.ttft_ok and self.tbt_ok
        return self.sla_met

    @property
    def done(self) -> bool:
        n_out = max(len(self.output_tokens), self._sim_outlen)
        if self.true_output_len:
            return n_out >= min(self.true_output_len, self.max_new_tokens)
        return n_out >= self.max_new_tokens
