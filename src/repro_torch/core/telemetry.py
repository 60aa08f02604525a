"""Rolling telemetry the controller consumes each scheduling interval.

Tracks request arrival rate lambda(t), prompt/output length moments
(EW-windowed), recent decode latency tau-bar (TBT), recent decode batch
size b-bar, and — in PD-fusion mode — per-lane prefill occupancy and
TTFT attribution (queueing vs prefill service, DESIGN §6). Pure Python —
shared by the real engine and the simulator (DESIGN §1).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, Dict, Mapping, Optional


@dataclasses.dataclass
class TelemetrySnapshot:
    n_prefill_waiting: int = 0       # N^p: requests with prefill work pending
    n_decode_running: int = 0        # N^d: requests currently decoding
    mean_in: float = 0.0             # E[l_in]
    var_in: float = 0.0
    mean_out: float = 0.0            # E[l_out] (observed completions, EW)
    var_out: float = 0.0
    tbt_ms: float = 0.0              # tau-bar: recent mean decode latency
    tbt_samples: int = 0             # decode steps in the TBT window (0 = cold)
    mean_batch: float = 0.0          # b-bar: recent mean decode batch size
    arrival_rate: float = 0.0        # lambda(t) req/s
    free_tokens: int = 0             # free KV-pool tokens (blocks*block_size)
    # prefix sharing (DESIGN §10): per-request footprints summed vs deduped
    # distinct-block usage — free_tokens counts evictable cached blocks as
    # free, these two make the dedup visible to the controller/operator
    logical_used_tokens: int = 0
    physical_used_tokens: int = 0
    # two-tier swap pressure (DESIGN §11): device tokens the swapped-out
    # backlog will re-claim on swap-in. Alg 1 subtracts this from its
    # capacity so admission cannot hand the swapped queue's headroom to
    # new requests and starve the swap-in path.
    swapped_tokens: int = 0
    now: float = 0.0
    # PD fusion (DESIGN §6): recent mean fraction of prefill lanes packed
    # with work, and EW-mean TTFT split into queueing vs prefill service
    prefill_lane_occupancy: float = 0.0
    ttft_queue_s: float = 0.0
    ttft_prefill_s: float = 0.0
    # async dispatch-ahead split (DESIGN §14): recent mean wall-time per
    # scheduling interval spent on host work (admission, lane packing,
    # block-table edits) vs blocked at the device-step retirement fence.
    # Under overlap the device share is the *marginal* wait — device time
    # the host could not hide — so host+device still sum to the interval.
    step_host_s: float = 0.0
    step_device_s: float = 0.0


class _Welford:
    """Exponentially-weighted mean/variance."""

    def __init__(self, halflife: float = 256.0):
        self.alpha = 1.0 - math.exp(-math.log(2.0) / halflife)
        self.mean: Optional[float] = None
        self.var = 0.0

    def update(self, x: float):
        if self.mean is None:
            self.mean = x
            self.var = 0.0
            return
        d = x - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)

    def get(self, default_mean: float = 0.0, default_var: float = 0.0):
        if self.mean is None:
            return default_mean, default_var
        return self.mean, self.var


class Telemetry:
    def __init__(self, window: int = 32, halflife: float = 256.0,
                 prior_mean_in: float = 0.0, prior_mean_out: float = 0.0):
        self.len_in = _Welford(halflife)
        self.len_out = _Welford(halflife)
        self.tbt: Deque[float] = collections.deque(maxlen=window)
        self.batch: Deque[int] = collections.deque(maxlen=window)
        self.arrivals: Deque[float] = collections.deque(maxlen=4 * window)
        self.prior_mean_in = prior_mean_in
        self.prior_mean_out = prior_mean_out
        # PD-fusion lane stats (DESIGN §6)
        self.lane_occ: Deque[float] = collections.deque(maxlen=window)
        self.lane_tokens: Dict[int, int] = {}     # lane -> prefill tokens packed
        self.lane_chunks: Dict[int, int] = {}     # lane -> chunks packed
        self.prefill_tokens_total = 0
        self.ttft_queue = _Welford(halflife)
        self.ttft_prefill = _Welford(halflife)
        # host-vs-device interval split (DESIGN §14)
        self.host_s: Deque[float] = collections.deque(maxlen=window)
        self.device_s: Deque[float] = collections.deque(maxlen=window)

    # -- event feeds --------------------------------------------------------
    def on_arrival(self, t: float, prompt_len: int):
        self.arrivals.append(t)
        self.len_in.update(float(prompt_len))

    def on_completion(self, output_len: int):
        self.len_out.update(float(output_len))

    def on_decode_step(self, tbt_ms: float, batch_size: int):
        self.tbt.append(tbt_ms)
        self.batch.append(batch_size)

    def on_prefill_interval(self, lane_tokens: Mapping[int, int],
                            n_lanes: int):
        """One PD-fused interval packed `lane_tokens[lane]` prefill tokens
        into each listed lane (DESIGN §6); n_lanes is the configured total."""
        self.lane_occ.append(len(lane_tokens) / max(n_lanes, 1))
        for lane, toks in lane_tokens.items():
            self.lane_tokens[lane] = self.lane_tokens.get(lane, 0) + toks
            self.lane_chunks[lane] = self.lane_chunks.get(lane, 0) + 1
            self.prefill_tokens_total += toks

    def on_first_token(self, queue_s: float, prefill_s: float):
        """TTFT attribution: time queued before the first prefill chunk vs
        time being chunk-prefilled until the first token (DESIGN §6)."""
        self.ttft_queue.update(max(queue_s, 0.0))
        self.ttft_prefill.update(max(prefill_s, 0.0))

    def on_interval(self, host_s: float, device_s: float):
        """One scheduling interval's wall-time split: host work (admission,
        lane packing, table edits) vs blocked wait at the retirement fence
        (DESIGN §14). Fed immediately, not via the stale-by-one contract —
        it describes the host loop itself, not the device step's output."""
        self.host_s.append(host_s)
        self.device_s.append(device_s)

    # -- snapshot ------------------------------------------------------------
    def arrival_rate(self, now: float, horizon: float = 10.0) -> float:
        """Arrivals per second over the observation horizon.

        Divides by the full horizon (clamped to elapsed time), NOT by
        `now - recent[0]`: a single fresh arrival would otherwise yield a
        1/1e-6 = 1e6 req/s spike that poisons the controller's lambda(t)."""
        recent = [a for a in self.arrivals if a > now - horizon]
        if not recent:
            return 0.0
        span = max(min(now, horizon), 1e-6)
        return len(recent) / span

    def snapshot(self, *, now: float, n_prefill: int, n_decode: int,
                 free_tokens: int, logical_used_tokens: int = 0,
                 physical_used_tokens: int = 0,
                 swapped_tokens: int = 0) -> TelemetrySnapshot:
        mi, vi = self.len_in.get(self.prior_mean_in, 0.0)
        mo, vo = self.len_out.get(self.prior_mean_out, 0.0)
        tbt = sum(self.tbt) / len(self.tbt) if self.tbt else 0.0
        mb = sum(self.batch) / len(self.batch) if self.batch else 0.0
        occ = sum(self.lane_occ) / len(self.lane_occ) if self.lane_occ else 0.0
        tq, _ = self.ttft_queue.get()
        tp, _ = self.ttft_prefill.get()
        hs = sum(self.host_s) / len(self.host_s) if self.host_s else 0.0
        ds = sum(self.device_s) / len(self.device_s) if self.device_s else 0.0
        return TelemetrySnapshot(
            n_prefill_waiting=n_prefill, n_decode_running=n_decode,
            mean_in=mi, var_in=vi, mean_out=mo, var_out=vo,
            tbt_ms=tbt, tbt_samples=len(self.tbt), mean_batch=mb,
            arrival_rate=self.arrival_rate(now), free_tokens=free_tokens,
            logical_used_tokens=logical_used_tokens,
            physical_used_tokens=physical_used_tokens,
            swapped_tokens=swapped_tokens,
            now=now, prefill_lane_occupancy=occ,
            ttft_queue_s=tq, ttft_prefill_s=tp,
            step_host_s=hs, step_device_s=ds)
