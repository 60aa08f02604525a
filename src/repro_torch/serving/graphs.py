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

With dispatch-ahead (DESIGN §14) steps of up to `overlap_depth` earlier
intervals may still be queued when a step runs. The one stream orders
them: a replay reads its static inputs after the earlier replays that
read them, and the sampled tokens of a step come from the normal
allocator and live in their interval's record. A tail chunk captured at
first use waits for the work in flight (the side stream waits on the
current one, and the capture synchronises the device before it starts).
Only host memory outlives the stream's order: `Staging` keeps one pinned
arena per interval in flight.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.serving.trace import span

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
        `ops.LAUNCHES` and added back at each replay. Inside a profiler
        range while a profiler is collecting (`trace.py`)."""
        with span(torch.autograd._profiler_enabled(), "graphs.capture"):
            self._capture(st)

    def _capture(self, st: Step) -> None:
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


class _Arena:
    """One interval's host staging memory: a bump allocator over one
    buffer, and the buffers it outgrew, kept until the rewind."""

    def __init__(self, nbytes: int, pin: bool):
        self.pin = pin
        self.buf = self._alloc(nbytes)
        self.outgrown: List[torch.Tensor] = []
        self.off = 0

    def _alloc(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.pin)

    def take(self, dtype: torch.dtype, shape) -> torch.Tensor:
        """A fresh slice of the arena, 8-byte aligned, as `dtype`."""
        n = max(1, int(np.prod(shape))) * torch.empty(
            (), dtype=dtype).element_size()
        off = -(-self.off // 8) * 8
        if off + n > self.buf.numel():
            self.outgrown.append(self.buf)
            self.buf = self._alloc(max(2 * self.buf.numel(), 2 * n))
            off = 0
        self.off = off + n
        return self.buf[off:off + n].view(dtype)[:int(np.prod(shape))] \
            .view(shape)

    def rewind(self) -> None:
        self.off = 0
        self.outgrown.clear()


class Staging:
    """Host staging of step inputs and readbacks: pinned memory on the
    card (pageable on the CPU), copied with `non_blocking=True`, so neither
    staging nor dispatching the readback waits for the stream.

    Dispatch-ahead (DESIGN §14) keeps up to `depth` intervals in flight
    while the host stages the next one, and a non-blocking copy reads its
    pinned source only when the stream reaches it. So staging keeps a ring
    of `depth + 1` arenas: the open interval stages into its own arena
    (each copy from its own slice of it), `seal()` hands that arena to the
    dispatched interval and opens the next one, and `release()` rewinds an
    arena only when its interval retires, after the readback event that
    follows every copy the interval enqueued. An interval that dispatched
    nothing keeps the arena open for the next one, so its copies are
    covered by that interval's event. Staging into, or sealing towards, an
    arena still in flight raises."""

    def __init__(self, device: torch.device, nbytes: int = 1 << 16,
                 depth: int = 0):
        pin = device.type == "cuda"
        self._ring = [_Arena(nbytes, pin) for _ in range(depth + 1)]
        self._open = 0
        self._in_flight: List[int] = []

    def _arena(self) -> _Arena:
        if self._open in self._in_flight:
            raise RuntimeError(f"staging arena {self._open} is still in "
                               f"flight")
        return self._ring[self._open]

    def copy(self, dst: torch.Tensor, host) -> None:
        """dst.copy_(host) through the open arena: `host` an array or a CPU
        tensor, converted to dst's dtype on the host first, so the device
        copy is a plain one."""
        src = host if isinstance(host, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(host))
        src = src.to(dst.dtype)
        pinned = self._arena().take(src.dtype, src.shape)
        pinned.copy_(src)
        dst.copy_(pinned, non_blocking=True)

    def readback(self, src: torch.Tensor) -> torch.Tensor:
        """A host tensor in the open arena that `src` is copied into
        without blocking: valid once the stream has passed the copy (at
        once on the CPU)."""
        host = self._arena().take(src.dtype, src.shape)
        host.copy_(src, non_blocking=True)
        return host

    def seal(self) -> int:
        """The open interval was dispatched: its arena is in flight until
        `release` and the next interval stages into the next arena. Returns
        the sealed arena's index."""
        i = self._open
        self._arena()
        self._in_flight.append(i)
        self._open = (i + 1) % len(self._ring)
        return i

    def release(self, i: int) -> None:
        """Interval retired: every copy through arena `i` has completed, so
        the arena is rewound for reuse."""
        self._in_flight.remove(i)
        self._ring[i].rewind()
