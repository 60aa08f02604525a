"""Serving groups and rank processes (DESIGN §12): the port's twin of the
JAX package's `launch/mesh.py`.

A mesh of shape (data, model) (or (pod, data, model)) is data·model rank
processes. The last axis is "model": ranks r with the same r // model
share a data index and form a tensor-parallel group; the data replicas run
the same computation, as the JAX engine's rows replicate over "data". The
ranks of one pod and model index form a data group, over which a
sequence-sharded decode gathers its partial results.
The backend is the caller's: NCCL on the card, gloo on the CPU. Nothing
switches it: NCCL with more ranks than cards fails with NCCL's own error.

The rendezvous is a file store in a temporary directory (no network);
every collective has the group's timeout, so a mismatched collective
fails instead of hanging.

The dry run's meshes (`launch.dryrun`) are axis sizes only, `{axis:
size}` maps with no process group: the JAX package's production meshes
(`make_production_mesh`, a TPU pod of 16 x 16 and two of them) and the
card layouts (`CARD_MESHES`: one H100, and one NVLink node of 8 as a
model axis of 8).
"""
from __future__ import annotations

import datetime
import math
import os
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distributed.sharding import ServingGroup, set_serving_group

#: the rendezvous of the ranks `spawn_ranks` starts (a file:// URL)
RENDEZVOUS_ENV = "REPRO_TORCH_RENDEZVOUS"
#: seconds a collective may wait before it fails
TIMEOUT_S = 300.0


#: the card layouts of the dry run: one H100, and one NVLink node of 8
CARD_MESHES = {"card": {"data": 1, "model": 1},
               "node": {"data": 1, "model": 8}}


def make_production_mesh(multi_pod: bool = False) -> Dict[str, int]:
    """The JAX package's production mesh as axis sizes: (data 16, model
    16), or (pod 2, data 16, model 16) with `multi_pod`."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def mesh_name(sizes: Dict[str, int]) -> str:
    """"16x16", "2x16x16", "1x8": the sizes in axis order."""
    return "x".join(str(n) for n in sizes.values())


def make_serving_group(mesh_shape: Sequence[int], backend: str, rank: int,
                       world: int, init_method: Optional[str] = None,
                       timeout_s: float = TIMEOUT_S) -> ServingGroup:
    """Join the ranks of a `mesh_shape` mesh as `rank` of `world` (their
    product), build the tensor-parallel groups, the data groups and the
    gloo control group (`mesh_group`), and install the result as the
    ambient serving group. `init_method` defaults to the rendezvous
    `spawn_ranks` gives its ranks."""
    shape = tuple(int(s) for s in mesh_shape)
    if not shape or len(shape) > 3 or math.prod(shape) != world:
        raise ValueError(f"mesh {shape} does not hold {world} ranks")
    if not dist.is_initialized():
        kw = {}
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group(
            backend, init_method=init_method or os.environ[RENDEZVOUS_ENV],
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    group = mesh_group(shape, backend, rank)
    set_serving_group(group)
    return group


def mesh_group(mesh_shape: Sequence[int], backend: str,
               rank: int) -> Optional[ServingGroup]:
    """The serving group of a `mesh_shape` mesh laid on the first
    prod(mesh_shape) ranks of the running process group: the tensor-
    parallel groups (m consecutive ranks), the data groups (one a pod and
    model index, m apart) and a gloo control group over the mesh. Every
    rank of the process group calls it alike (each group is made by all
    of them); a rank past the mesh gets None. On NCCL one all-reduce
    initialises the communicator before any step is captured in a CUDA
    graph."""
    shape = tuple(int(s) for s in mesh_shape)
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {n} ranks, the process group "
                         f"has {dist.get_world_size()}")
    m = shape[-1]
    D = shape[-2] if len(shape) > 1 else 1
    tp = dp = None
    for d in range(n // m):          # every rank creates every group
        g = dist.new_group(list(range(d * m, (d + 1) * m)), backend=backend)
        if rank // m == d:
            tp = g
    for p0 in range(0, n, D * m):
        for j in range(m):
            ranks = [p0 + d * m + j for d in range(D)]
            g = dist.new_group(ranks, backend=backend) if D > 1 else None
            if rank in ranks:
                dp = g
    control = dist.new_group(list(range(n)), backend="gloo")
    if rank >= n:
        return None
    group = ServingGroup(shape, rank, n, backend, tp, control, dp)
    if backend == "nccl":
        group.all_reduce(torch.zeros(1, device="cuda"))
        torch.cuda.synchronize()
    return group


def close_serving_group() -> None:
    """Leave the ranks: the ambient group is cleared and the process group
    destroyed."""
    set_serving_group(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(fn, rank: int, world: int, init_method: str, args: tuple,
               results) -> None:
    os.environ[RENDEZVOUS_ENV] = init_method
    try:
        out = fn(rank, world, *args)
        results.put((rank, True, out if rank == 0 else None))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        close_serving_group()


def spawn_ranks(fn: Callable[..., Any], world: int, args: tuple = (),
                timeout_s: float = TIMEOUT_S) -> Any:
    """Run fn(rank, world, *args) in `world` spawned processes (fn must be
    importable: a module-level function) and return rank 0's result. The
    ranks meet at a file store (`RENDEZVOUS_ENV`) and join their groups
    themselves (`make_serving_group`). Rank 0's result is pickled to this
    process after the rank has finished, so it must hold no tensor (torch
    shares a tensor's storage through a descriptor of the exiting
    process): lists, numbers, numpy arrays. A rank that raises, or a run
    that outlasts `timeout_s`, ends every rank and raises here."""
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory() as d:
        init = f"file://{d}/store"
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, init, tuple(args), results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        out, done, error = None, 0, None
        try:
            while done < world and error is None:
                if not results.empty():
                    rank, ok, value = results.get()
                    done += 1
                    if not ok:
                        error = f"rank {rank} failed:\n{value}"
                    elif rank == 0:
                        out = value
                    continue
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    error = f"a rank exited with code {dead[0].exitcode}"
                elif time.monotonic() > deadline:
                    error = f"the ranks did not finish in {timeout_s} s"
                else:
                    time.sleep(0.01)
        finally:
            for p in procs:
                p.join(timeout=30 if error is None else 1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if error is not None:
        raise RuntimeError(f"spawn_ranks: {error}")
    return out
