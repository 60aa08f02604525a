"""The port's justified allowlist (DESIGN §13).

Every entry suppresses exactly `count` findings of `rule` in `path`
(narrowed to one qualified `scope`) and carries a real justification:
the framework rejects reasons under MIN_REASON chars, entries matching no
finding (stale) and entries matching another number of findings than
declared (count drift: a new unreviewed site hiding behind an old
excuse).

The port keeps its own list: its engine has other sync sites than the
JAX engine's (a CUDA event and a pinned readback instead of
`block_until_ready` and `device_get`; its warmup captures graphs without
a host wait, and its swap path copies without blocking), so the JAX
entries would be stale here and the port's would be unknown there.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.framework import Allow

ENGINE = "src/repro_torch/serving/engine.py"

ALLOWLIST: List[Allow] = [
    Allow("host-sync", ENGINE, "Engine._retire_step", 2,
          "the pipeline fence (DESIGN §14): one wait on the retired "
          "interval's CUDA event, the measured step_device_s and TBT "
          "sample, then the readback of its pinned token buffer, which "
          "that event already covers; the only blocking pair the "
          "dispatch-ahead loop keeps"),
    Allow("host-sync", ENGINE, "Engine._host_extras", 1,
          "a caller's VLM or enc-dec extras are moved to host staging at "
          "submit, before admission and off every replayed step; a device "
          "tensor given here is the caller's choice to pay one copy"),
    Allow("counter-parity", ENGINE, "Engine.summary", 2,
          "copy_rows/copy_bytes count physical tensor row moves during "
          "compaction and copy-on-write; the sim has no tensor storage, so "
          "no twin can exist"),
]
