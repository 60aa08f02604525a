"""Compiled serving steps: one CUDA graph per step shape, the port's
counterpart of the reference engine's `jax.jit` wrappers
(`src/repro/serving/engine.py`, `_decode_jit` and its twins).

A `Step` is one shape key's step: its static input buffers on the device,
the function that runs the model on them and returns the last-position
logits, and, in graph mode, the CUDA graph captured from that function,
its static output and the kernel launches it recorded. The engine stages
each interval's inputs into the buffers (`Staging`) and runs the step: a
replay in graph mode, the function itself in eager mode (the CPU, or
`Engine(cuda_graphs=False)` on the card).

Capture follows PyTorch's recipe: an eager run on a side stream, then the
capture on that stream. Every graph allocates from one shared memory pool,
so a graph's intermediates may lie where another graph's output lives:
each step's output must be consumed (argmax, sampling) before any other
step runs. A failed capture raises; nothing falls back to eager.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

#: eager runs on the side stream before a capture (lazy initialisation:
#: the kernel libraries, cuBLAS's workspace on that stream, the kernels'
#: one-time attributes)
WARMUP_RUNS = 1


@dataclasses.dataclass
class Step:
    """One shape key's step. `inputs` hold all-padding values until the
    engine stages a real step into them."""
    key: Tuple
    inputs: Dict[str, torch.Tensor]
    fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
    #: contiguous cache rows the step writes (their state is kept across
    #: the eager runs before a capture); None in the paged layout
    cache_rows: Optional[slice] = None
    graph: Optional[torch.cuda.CUDAGraph] = None
    out: Optional[torch.Tensor] = None
    #: kernel launches one run of the graph makes, recorded at capture
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: host copies of the inputs staged last (block tables, state slots),
    #: which are copied again only when they change
    host: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def run(self, eager: bool = False) -> torch.Tensor:
        """The step's logits (rows, V): a replay of the graph, or (eager,
        or no graph) the function on the same buffers."""
        if self.graph is None or eager:
            return self.fn(self.inputs)
        self.graph.replay()
        for name, n in self.launches.items():
            ops.LAUNCHES[name] += n
        return self.out


class StepGraphs:
    """The engine's steps by shape key, and their captures."""

    def __init__(self, device: torch.device, enabled: bool):
        if enabled and device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device; on the CPU "
                             "the engine runs eager")
        self.device = device
        self.enabled = enabled
        self.steps: Dict[Tuple, Step] = {}
        self.captures = 0
        self.capture_s = 0.0
        #: device bytes the shared pool reserved during the captures
        self.pool_bytes = 0
        if enabled:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)

    def capture(self, st: Step) -> None:
        """WARMUP_RUNS eager runs of the step on the side stream (their
        launches are real and stay counted), then its capture into the
        shared pool; the launches the capture recorded are taken out of
        `ops.LAUNCHES` and added back at each replay."""
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            for _ in range(WARMUP_RUNS):
                st.fn(st.inputs)
        cur.wait_stream(self.stream)
        counted = dict(ops.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a finaliser freeing a
        # dead engine's pinned arena records CUDA events on the legacy
        # default stream, which invalidates a capture in progress
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                r0 = torch.cuda.memory_reserved(self.device)
                out = st.fn(st.inputs)
                self.pool_bytes += torch.cuda.memory_reserved(self.device) \
                    - r0
        finally:
            if gc_was_on:
                gc.enable()
        st.launches = {k: n - counted[k] for k, n in ops.LAUNCHES.items()
                       if n != counted[k]}
        ops.LAUNCHES.update(counted)
        st.graph, st.out = graph, out
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def stats(self) -> Dict[str, float]:
        return {"steps": len(self.steps), "captures": self.captures,
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes}


class Staging:
    """Host staging of step inputs: pinned memory on the card (pageable on
    the CPU), copied to the device with `non_blocking=True`, so staging
    never waits for the stream.

    Each copy reads its own slice of the arena, and the arena is rewound
    only by `rewind()`, which the engine calls after the interval's
    readback: at `overlap_depth` 0 that readback is the fence after which
    every copy that read the arena has completed. (Dispatch-ahead, DESIGN
    §14, keeps intervals in flight past it and will need an arena per
    interval in flight.) An arena outgrown mid-interval is kept until the
    rewind."""

    def __init__(self, device: torch.device, nbytes: int = 1 << 16):
        self.pin = device.type == "cuda"
        self._buf = self._alloc(nbytes)
        self._outgrown: List[torch.Tensor] = []
        self._off = 0

    def _alloc(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pin)

    def copy(self, dst: torch.Tensor, host: np.ndarray) -> None:
        """dst.copy_(host) through the arena (host converted to dst's dtype
        on the host first, so the device copy is a plain one)."""
        src = torch.from_numpy(np.ascontiguousarray(host)).to(dst.dtype)
        n = src.numel() * src.element_size()
        off = -(-self._off // 8) * 8
        if off + n > self._buf.numel():
            self._outgrown.append(self._buf)
            self._buf = self._alloc(max(2 * self._buf.numel(), 2 * n))
            off = 0
        pinned = self._buf[off:off + n].view(src.dtype).view(src.shape)
        pinned.copy_(src)
        self._off = off + n
        dst.copy_(pinned, non_blocking=True)

    def rewind(self) -> None:
        self._off = 0
        self._outgrown.clear()
