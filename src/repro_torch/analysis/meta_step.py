"""One rank's step on the meta device: what the dry run (`launch.dryrun`)
reads in place of the JAX package's compile.

* `RecordingGroup`: a `ServingGroup` of one rank of a mesh that records
  each all-reduce and all-gather (over the model axis, or the data axis of
  a sequence-sharded decode) and its bytes (under the JAX dry run's
  keys, the output's bytes as its HLO parse counts them) and returns a
  tensor of the right shape; a rank's model takes it as its group.
* `PeakMemory`: a dispatch mode that tracks the bytes of every storage
  an op under it allocates, live until Python frees it, and their peak:
  the step's memory above its arguments (made before it), the
  `temp_size_in_bytes` of XLA's `memory_analysis`.
* `run`: a step under both, and under `torch.utils.flop_counter.
  FlopCounterMode` (the matmuls, convolutions and attention products of
  the plain ops) plus the kernels' meta FLOPs (`kernels.meta`), the
  `cost_analysis` flops.
"""
from __future__ import annotations

import math
import time
import weakref
from typing import Any, Callable, Dict, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed.sharding import ServingGroup
from repro_torch.kernels import meta

#: the collective kinds of the JAX dry run's HLO parse
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def no_collectives() -> Dict[str, int]:
    return dict.fromkeys(KINDS + ("count",), 0)


class RecordingGroup(ServingGroup):
    """Rank `rank` of a `mesh_shape` mesh with no process group: each
    collective is recorded in `collectives` and returns its input (an
    all-reduce) or a new tensor of the gathered shape (an all-gather);
    the values are not the group's, so it serves meta runs."""

    def __init__(self, mesh_shape: Sequence[int], rank: int = 0):
        shape = tuple(int(s) for s in mesh_shape)
        super().__init__(shape, rank, math.prod(shape), "meta", None, None)
        self.reset()

    def reset(self) -> None:
        """Clear the record: `collectives` (bytes by kind, and "count")
        and `calls` (the calls by kind)."""
        self.collectives = no_collectives()
        self.calls = dict.fromkeys(KINDS, 0)

    def _record(self, kind: str, t: torch.Tensor) -> None:
        self.collectives[kind] += t.numel() * t.element_size()
        self.collectives["count"] += 1
        self.calls[kind] += 1

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        self._record("all-reduce", x)
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_empty(tuple(x.shape[:-1])
                          + (self.model_size * x.shape[-1],))
        self._record("all-gather", out)
        return out

    def gather_data(self, x: torch.Tensor) -> torch.Tensor:
        out = x.new_empty((self.data_size,) + tuple(x.shape))
        self._record("all-gather", out)
        return out


def _tensors(values):
    """The tensors among `values` and in their lists and tuples (an op's
    arguments or outputs)."""
    for v in values:
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, (list, tuple)):
            yield from _tensors(v)


class PeakMemory(TorchDispatchMode):
    """The live bytes of the storages allocated by the ops run under it,
    and their peak. An op's output whose storage is one of its inputs'
    (a view, an in-place op) allocates nothing; a new storage counts
    from the op that made it until it is freed."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._ids = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        old = {id(t.untyped_storage()) for t in _tensors(args)}
        old.update(id(t.untyped_storage()) for t in _tensors(kwargs.values()))
        for t in _tensors(out if isinstance(out, (list, tuple)) else (out,)):
            st = t.untyped_storage()
            if id(st) not in old:
                self._allocated(st)
                old.add(id(st))
        return out

    def _allocated(self, st) -> None:
        key = id(st)
        if key in self._ids:
            return
        self._ids.add(key)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._freed, key, n)

    def _freed(self, key: int, n: int) -> None:
        self._ids.discard(key)
        self.live -= n


def run(step: Callable[[], Any], group=None) -> Dict[str, Any]:
    """step() under `PeakMemory` and the FLOP counters: {"temp_bytes":
    its peak above what existed before, "flops", "collectives" (a
    `RecordingGroup`'s, from this step only), "meta_s"}. On any device:
    the kernels' meta FLOPs count only on meta tensors."""
    meta.reset()
    if group is not None:
        group.reset()
    t0 = time.perf_counter()
    with PeakMemory() as mem, FlopCounterMode(display=False) as fc:
        step()
    return {"temp_bytes": mem.peak,
            "flops": fc.get_total_flops() + sum(meta.FLOPS.values()),
            "collectives": dict(group.collectives) if group is not None
            else no_collectives(),
            "meta_s": time.perf_counter() - t0}
