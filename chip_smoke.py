"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one JSON line each:

1. env       the card (nvidia-smi name and power limit), torch and CUDA
             versions; TF32 off for fp32 products.
2. build     nvcc builds every CUDA kernel of the port (one process per
             source, all at once). Registers and spill bytes per kernel
             instantiation, from ptxas; a spill or a stack frame in a bf16
             tensor-core attention kernel (contiguous or paged), in any SSD
             kernel or in any RG-LRU kernel fails, and so does a build
             without the paged instantiations or an SSD library whose SASS
             (cuobjdump) holds no TF32 tensor-core instruction
             (HMMA.1688.F32.TF32).
3. kernels   each of the 9 kernel entries against its plain PyTorch version
             on the card at the serving path's shapes (the attention
             kernels, RMSNorm and the gated RG-LRU recurrence in bf16
             against the fp32 plain version, the SSD term, the RG-LRU scan
             and one gated case in fp32 against their fp32 plain
             versions), with CUDA-event timings (median of 30 runs after
             warm-up, L2 flushed before each run) of the kernel, its plain
             version and the nearest PyTorch library call, and the least
             time the card could take (bound_ms, with the peak it was taken
             against). A bf16 attention call is timed whole: the split pass
             and, where the key axis is split, the combine pass. One decode
             case has rows filled to 33-512 of 1024 slots, as in serving;
             its bound counts the visible slots' K/V and every slot's k_pos.
             Paged decode runs beside the contiguous kernel on the same
             rows (the gathered view) as its yardstick, paged chunks beside
             the contiguous chunk cases. The fused add + RMSNorm's sum must
             be bit for bit `x + y`. The norms' rows also carry host_us,
             the wall time per launch of 1000 back-to-back launches, for
             the kernel and for its library call; the RG-LRU rows for the
             kernel and its plain version, and the gated rows the device
             and host time of the eager chain the model ran before (the
             gates op by op, then the scan kernel). The launch-floor cases
             (RMSNorm and the fused add 8 x 4096, decode B 8 S 1024, gated
             RG-LRU B 8 T 1) also carry graph_ms: 100 launches captured in
             one CUDA graph, replay time / 100, beside stream_ms, the same
             100 launches queued eagerly behind a spin kernel (warm L2 in
             both).
4. reference per family, full width with depth cut to one layer pattern
             (granite-3-8b 2 layers, mamba2-2.7b 2, recurrentgemma-9b 3):
             the kernels' path on the card in bf16 against the plain path
             on the CPU in fp32 with the same weights, over a prefill and a
             few decode steps (mamba2 and recurrentgemma prefill 300 tokens:
             two SSD chunks, the second padded); recurrentgemma's prefill
             and decode steps launch the gated RG-LRU kernel once a
             recurrent layer and the plain scan kernel never.
5. serve_<arch>_contiguous / serve_<arch>_paged
             the engine at full width and depth (random weights from seed
             0) through `repro_torch.launch.serve.build_engine`, its CUDA
             graphs captured by `Engine.warmup` (every decode bucket and
             full-chunk lane shape; tail chunks at first use), for
             granite-3-8b
             (12 requests), mamba2-2.7b and recurrentgemma-9b (8 each):
             prompts of 32-480 tokens, 32 new tokens, chunked prefill on 2
             lanes, policy `memory`, each path's kernel launches counted.
             Every request finishes, the structural counters agree across
             the two layouts, and mamba2 preempts nothing and ends with the
             allocator full. Paged runs attend through the block table
             only (paged decode and paged chunks, no contiguous attention
             launch); contiguous runs launch no paged kernel; every
             forward launches the fused add + RMSNorm and the plain RMSNorm
             its family's number of times (granite 80 + 1, mamba2 64 + 65,
             recurrentgemma 76 + 1), and recurrentgemma launches the gated
             RG-LRU kernel 26 times a forward and the plain scan kernel
             never (it is the TPU kernel's direct counterpart, checked in
             the kernels phase only). Every step is a graph replay, which
             adds the launches its capture recorded. Each line carries
             step_host_s_mean, step_device_s_mean (the readback wait, the
             TBT sample), their sum (the interval's wall time), build_s
             (model, engine, warmup) and the graph counts.
6. graphs_<arch>_<layout>
             on each serve run's engine: decode at bucket 8 and a lane's
             full chunk, from random cache contents and inputs, replayed
             and run eagerly: logits and cache bit for bit equal; the
             graph count, capture seconds and the shared pool's bytes.
7. serve_granite-3-8b_contiguous_eager
             granite's contiguous run again with every step eager
             (`cuda_graphs=False`): the graph run's tokens and structural
             counters, and the host time the graphs took away.
8. serve_<arch>_<layout>_overlap2
             granite-3-8b in both layouts and recurrentgemma-9b paged
             served again on graphs with two intervals dispatched ahead
             (`--overlap-depth 2`, DESIGN §14): the depth-0 run's tokens
             bit for bit and its structural counters; each line carries
             its host, device and interval means and tokens/s with the
             depth-0 run's beside them (`depth0`).
9. twin_granite-3-8b_<layout>
             the port's simulator (`serving/sim.py`) on the same
             ServeConfig, prompt lengths, capped max_new_tokens,
             max_context and prefill chunk, prior-free telemetry, every
             arrival at 0, at depth 0 and 2: admitted, preemptions,
             oom_events, rejected, the finished, rejected and SLA-met sets,
             sla_requests_met and goodput_tokens equal the engine's at the
             same depth; decode_steps and mean_batch printed beside.
10. profile, profile_overlap2
             last (a process that has run the tracer launches slower
             after it), on fresh granite contiguous engines at depth 0 and
             at depth 2: 8 requests are promoted, then two consecutive
             decode intervals at bucket 8 run under `torch.profiler`
             (traces in chiprun_out/): the first one's CUDA runtime calls,
             the blocking ones before its retirement's event wait
             (`cudaEventSynchronize`, the only one allowed), H2D copies
             from pageable memory (none may be), the device's busy share,
             and the device's gap between the last work the first call
             launched and the first work the second launched; at depth 2
             every traced call must leave two intervals in flight.

Then the card's name and power limit, the `{"kernels": [...]}` summary,
and as the last line `{"ok": true, "device": {...}}`. Any failure raises:
the script exits non-zero and prints no result. It also refuses to run
without a GPU or outside a checkout of the repository.
"""
from __future__ import annotations

import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense FLOP/s by
#: input type (TF32 is the fastest the card multiplies fp32 inputs)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 494.7e12, "fp32": 67e12}
#: bf16 kernel output against the fp32 plain version
ATOL = RTOL = 2e-2
#: fp32 kernels against their fp32 plain version: every element within
#: FP32_TOL * max|plain| (the same sums, taken in another order)
FP32_TOL = 1e-4

SERVE_ARGS = ["--variant", "full", "--policy", "memory", "--b-max", "8",
              "--batch-buckets", "1,2,4,8", "--chunked", "--lanes", "2",
              "--chunk-budget", "512", "--max-context", "1024",
              "--block-size", "16", "--pool-tokens", "8192",
              "--max-new", "32", "--seed", "0", "--device", "cuda"]
PROMPT_LO, PROMPT_HI = 32, 480
#: arch -> (requests served, kernels its main path must launch in both
#: layouts, whether it attends (the layout's decode and chunk kernels are
#: then added), (fused add + RMSNorm, plain RMSNorm) launches per forward,
#: other kernels' launches per forward, prefill chunks and decode steps
#: alike)
FAMILIES = {
    "granite-3-8b": (12, ("rmsnorm", "add_rmsnorm"), True, (80, 1), {}),
    "mamba2-2.7b": (8, ("ssd_intra", "rmsnorm", "add_rmsnorm"), False,
                    (64, 65), {}),
    "recurrentgemma-9b": (8, ("rglru_gated_scan", "rmsnorm", "add_rmsnorm"),
                          True, (76, 1),
                          {"rglru_gated_scan": 26, "rglru_scan": 0}),
}
#: kernels no serve run launches: the TPU kernel's direct counterpart,
#: which the model's gated entry replaced on the path
OFF_PATH = ("rglru_scan",)
#: attention kernels by layout (paged?): (decode, chunk)
ATTENTION = {False: ("decode_attention", "flash_attention"),
             True: ("paged_decode_attention", "paged_flash_attention")}
STRUCTURAL = ("decode_steps", "mean_batch", "admitted", "preemptions",
              "prefill_tokens", "finished")
#: the serve run whose decode interval is traced, and served again eager
PROFILED = ("granite-3-8b", "contiguous")
#: serve runs served again with two intervals dispatched ahead (DESIGN §14)
OVERLAPPED = (("granite-3-8b", "contiguous"), ("granite-3-8b", "paged"),
              ("recurrentgemma-9b", "paged"))
OVERLAP_DEPTH = 2
#: the engine-vs-simulator counters (tests/test_differential.py
#: `assert_parity`); the finished, rejected and SLA-met sets are compared too
TWIN = ("admitted", "preemptions", "oom_events", "rejected",
        "sla_requests_met", "goodput_tokens")
#: serve runs held against the port's simulator
TWINNED = ("granite-3-8b",)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# ---------------------------------------------------------------------------
# timing


def time_ms(fn, flush, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of `fn` over `reps` runs, by CUDA events. A spin
    kernel queued first keeps the card busy while the host enqueues every
    run, so host launch gaps stay out of the events; the L2 is flushed
    before each run, outside its events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for s, e in pairs:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_us(fn, n: int = 1000, warmup: int = 50) -> float:
    """Host microseconds per launch: the wall time of n back-to-back calls
    after warm-up, with one synchronize at the end, over n."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def graph_ms(fn, n: int = 100, reps: int = 20):
    """(graph_ms, stream_ms): device ms a launch of `fn` when n launches
    are captured in one CUDA graph and replayed (median of `reps` replays
    by CUDA events, over n), and when the same n launches are queued
    eagerly behind a spin kernel (host gaps hidden). The L2 is warm in
    both: the launches reread the same operands."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in pairs:
        s.record()
        graph.replay()
        e.record()
    torch.cuda.synchronize()
    replay = statistics.median(s.elapsed_time(e) for s, e in pairs) / n
    del graph
    eager = []
    for _ in range(3):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        torch.cuda._sleep(200_000_000)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        eager.append(s.elapsed_time(e) / n)
    return replay, statistics.median(eager)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float, peak: str):
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = n_ops / PEAK_FLOPS[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    """Max abs error over the outputs (a tensor or a tuple of them); raises
    when an element is outside the tolerance: atol + rtol|want| for a bf16
    output, FP32_TOL * max|want| for an fp32 one."""
    if isinstance(got, tuple):
        return max(max_err(g, w) for g, w in zip(got, want))
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        bad = d > FP32_TOL * want.abs().max()
    else:
        bad = d > ATOL + RTOL * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()) or bool(bad.any()):
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"max abs err {float(d.max())}")
    return float(d.max())


# ---------------------------------------------------------------------------
# phase 2: build

#: the port's kernel entry functions, as they appear in mangled names
KERNEL_NAMES = ("mma_attention_kernel", "mma_combine_kernel", "decode_kernel",
                "flash_kernel", "rmsnorm_kernel", "ssd_kernel", "rglru_kernel")


def _label(mangled: str) -> str:
    """`name<template args>` of a mangled kernel name (dtype, ints, bools)."""
    name = next((n for n in KERNEL_NAMES if n in mangled), mangled)
    tail = mangled.split(name, 1)[-1]
    if not tail.startswith("I"):
        return name
    args = [("bf16" if m.group(0)[0] == "1" else "fp32" if m.group(0) == "f"
             else m.group(1) or ("true" if m.group(2) == "1" else "false"))
            for m in re.finditer(r"13__nv_bfloat16|Li(\d+)E|Lb([01])E|f",
                                 tail[1:tail.find("Ev")])]
    return f"{name}<{', '.join(args)}>"


def ptxas_table(logs):
    """One row per kernel instantiation from `ptxas -v` output: library,
    kernel (name and template arguments), registers, stack frame and spill
    bytes."""
    rows, spills = [], {}
    for lib, log in logs.items():
        prop = None
        for ln in log.splitlines():
            if m := re.search(r"Compiling entry function '([^']+)'", ln):
                rows.append(dict(lib=lib, mangled=m.group(1)))
            elif m := re.search(r"Function properties for (\S+)", ln):
                prop = m.group(1)
            elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes "
                                r"spill stores, (\d+) bytes spill loads", ln):
                spills[prop] = tuple(int(x) for x in m.groups())
            elif (m := re.search(r"Used (\d+) registers", ln)) and rows:
                rows[-1]["registers"] = int(m.group(1))
    for r in rows:
        r["kernel"] = _label(r["mangled"])
        r["stack"], r["spill_stores"], r["spill_loads"] = spills.get(
            r.pop("mangled"), (0, 0, 0))
    return rows


def tf32_hmma_count(lib: str) -> int:
    """TF32 tensor-core instructions (HMMA.1688.F32.TF32) in the SASS of
    `build/kernels/lib<lib>.so`, by cuobjdump from the CUDA toolkit."""
    import shutil
    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "--dump-sass", str(_build._lib_path(lib))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return sass.count("HMMA.1688.F32.TF32")


# ---------------------------------------------------------------------------
# phase 3: kernels


def kernel_cases(dev):
    """(kernel, label, kernel call, plain call, fp32 plain call, library
    call or None, bytes, operations, peak[, extra calls to time by name])
    at the serving path's shapes: granite-3-8b's attention (32 heads on 8
    kv heads of 128) and recurrentgemma-9b's (16 heads on 1 kv head of
    256), RMSNorm at d 4096, the SSD term at mamba2-2.7b's widths and the
    RG-LRU recurrence at width 4096 (with ragged widths of 1000)."""
    import torch.nn.functional as F
    from repro_torch.bench.rglru_sweep import gated_inputs
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def f32(*a):
        return [t.float() if t.is_floating_point() else t for t in a]

    cases = []

    def decode(B, S, H, KV, hd, label, window=0, fill=None):
        """One query per row at position q_pos over an S-slot ring row; or,
        with `fill`, row b filled to fill[b] slots (the rest empty) and its
        query at fill[b] - 1, the bound counting the visible slots' K/V and
        every slot's k_pos."""
        q, k, v = rn(B, H, hd), rn(B, S, KV, hd), rn(B, S, KV, hd)
        ar = torch.arange(S, dtype=torch.int32, device=dev)
        if fill is None:
            last = S - 1 + (window // 2 if window else 0)
            qp = torch.full((B,), last, dtype=torch.int32, device=dev)
            kp = torch.where(ar + S <= last, ar + S, ar).repeat(B, 1)
        else:
            n = torch.tensor(fill, dtype=torch.int32, device=dev)
            qp = n - 1
            kp = torch.where(ar[None] < n[:, None], ar[None], -1)
        vis = (kp >= 0) & (kp <= qp[:, None])
        if window:
            vis &= kp > qp[:, None] - window
        kv_bytes = nbytes(k, v) if fill is None \
            else int(vis.sum()) * KV * hd * 2 * 2
        a = (q, k, v, qp, kp)
        cases.append((
            "decode_attention", label,
            lambda a=a: ops.decode_attention(*a, window=window),
            lambda a=a: ref.decode_attention_ref(*a, window=window),
            lambda a=a: ref.decode_attention_ref(*f32(*a), window=window),
            lambda q=q, k=k, v=v, m=vis[:, None, None, :]:
                F.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=m, enable_gqa=True),
            nbytes(q, qp, kp, q) + kv_bytes, 4 * hd * H * int(vis.sum()),
            "bf16"))

    def pools(KV, hd, lens):
        """The serving pool (8192 tokens in blocks of 16) and tables of 64
        entries (1024 slots a row) with shuffled physical ids and -1 tails:
        row b holds positions [0, lens[b])."""
        NB, bs, MB = 512, 16, 64
        kpool, vpool = rn(NB, bs, KV, hd), rn(NB, bs, KV, hd)
        perm = torch.randperm(NB, generator=g, device=dev)
        tables = torch.full((len(lens), MB), -1, dtype=torch.int32,
                            device=dev)
        kpos = torch.full((NB, bs), -1, dtype=torch.int32, device=dev)
        used = 0
        for b, n in enumerate(lens):
            nb = -(-n // bs)
            ids = perm[used:used + nb]
            used += nb
            tables[b, :nb] = ids.to(torch.int32)
            pos = torch.arange(nb * bs, dtype=torch.int32, device=dev)
            kpos[ids] = torch.where(pos < n, pos, -1).reshape(nb, bs)
        blocks = int((tables >= 0).sum())
        # the bytes a walk must read: every allocated block's K, V, k_pos
        read = blocks * (bs * KV * hd * 2 * 2 + bs * 4) + nbytes(tables)
        return kpool, vpool, kpos, tables, blocks, read

    def paged(H, KV, hd, label, lens=(1024, 1000, 777, 512, 301, 160, 33,
                                          1)):
        """Decode over rows of `lens` tokens (by default ragged, 1 to 1024,
        as a serving batch); beside it the contiguous kernel on the same
        rows (the gathered view), whose bound counts the visible slots' K/V
        and every slot's k_pos."""
        kpool, vpool, kpos, tables, blocks, read = pools(KV, hd, lens)
        q = rn(len(lens), H, hd)
        qp = torch.tensor([n - 1 for n in lens], dtype=torch.int32,
                          device=dev)
        a = (q, kpool, vpool, qp, kpos, tables)
        cases.append((
            "paged_decode_attention", f"{label}{blocks}",
            lambda a=a: ops.paged_decode_attention(*a),
            lambda a=a: ref.paged_decode_attention_ref(*a),
            lambda a=a: ref.paged_decode_attention_ref(*f32(*a)),
            None, read + nbytes(q, qp, q), 4 * hd * H * sum(lens), "bf16"))
        k, v, kp = ref.paged_view(kpool, vpool, kpos, tables)
        c = (q, k, v, qp, kp)
        cases.append((
            "decode_attention", f"{label}{blocks} contiguous, same rows",
            lambda c=c: ops.decode_attention(*c),
            lambda c=c: ref.decode_attention_ref(*c),
            lambda c=c: ref.decode_attention_ref(*f32(*c)),
            None, sum(lens) * KV * hd * 2 * 2 + nbytes(q, qp, kp, q),
            4 * hd * H * sum(lens), "bf16"))

    def paged_chunk(Tq, H, KV, hd, label):
        """A chunk of Tq queries ending at position 496 (or Tq) through the
        block table of a row whose blocks hold positions up to it (the
        flash cases' row, paged)."""
        end = max(496, Tq)
        kpool, vpool, kpos, tables, blocks, read = pools(KV, hd, [end])
        q = rn(1, Tq, H, hd)
        qp = torch.arange(end - Tq, end, dtype=torch.int32, device=dev)[None]
        n_vis = sum(min(p + 1, end) for p in range(end - Tq, end))
        a = (q, kpool, vpool, qp, kpos, tables)
        cases.append((
            "paged_flash_attention", label,
            lambda a=a: ops.paged_flash_attention(*a),
            lambda a=a: ref.paged_flash_attention_ref(*a),
            lambda a=a: ref.paged_flash_attention_ref(*f32(*a)),
            None, read + nbytes(q, qp, q), 4 * hd * H * n_vis, "bf16"))

    def flash(Tq, H, KV, hd, label):
        """A chunk of Tq queries ending at position 496 (or Tq) against a
        1024-slot cache row filled up to it (slots past it empty)."""
        Tk = 1024
        end = max(496, Tq)
        q, k, v = rn(1, Tq, H, hd), rn(1, Tk, KV, hd), rn(1, Tk, KV, hd)
        qp = torch.arange(end - Tq, end, dtype=torch.int32, device=dev)[None]
        ar = torch.arange(Tk, dtype=torch.int32, device=dev)
        kp = torch.where(ar < end, ar, -1)[None]
        mask = ((kp[:, None, :] >= 0)
                & (kp[:, None, :] <= qp[:, :, None]))[:, None]
        a = (q, k, v, qp, kp)
        cases.append((
            "flash_attention", label,
            lambda a=a: ops.flash_attention(*a),
            lambda a=a: ref.flash_attention_ref(*a),
            lambda a=a: ref.flash_attention_ref(*f32(*a)),
            lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=m, enable_gqa=True),
            nbytes(q, q, qp) + end * KV * hd * 2 * 2 + end * 4,
            4 * hd * H * int(mask.sum()), "bf16"))

    # granite-3-8b
    for B, S in ((1, 1024), (1, 1000), (8, 1024), (8, 1000)):
        decode(B, S, 32, 8, 128, f"B={B} S={S}")
    # serving fill: prompts of 32-480 tokens plus up to 32 new ones
    decode(8, 1024, 32, 8, 128, "B=8 S=1024 fill=33-512",
           fill=[33, 100, 160, 240, 301, 384, 450, 512])
    paged(32, 8, 128, "B=8 blocks=")
    paged(32, 8, 128, "B=8 fill=33-512 blocks=",
          lens=[33, 100, 160, 240, 301, 384, 450, 512])
    paged(32, 8, 128, "B=8 S=1024 blocks=", lens=[1024] * 8)
    for Tq in (16, 500):
        flash(Tq, 32, 8, 128, f"Tq={Tq} Tk=1024")
        paged_chunk(Tq, 32, 8, 128, f"Tq={Tq} MB=64 bs=16")
    # recurrentgemma-9b: hd 256, 16 query heads on one kv head
    decode(8, 1024, 16, 1, 256, "B=8 S=1024 hd=256")
    decode(8, 2048, 16, 1, 256, "B=8 S=2048 window=2048 hd=256",
           window=2048)
    paged(16, 1, 256, "B=8 hd=256 blocks=")
    for Tq in (16, 500):
        flash(Tq, 16, 1, 256, f"Tq={Tq} Tk=1024 hd=256")
        paged_chunk(Tq, 16, 1, 256, f"Tq={Tq} MB=64 bs=16 hd=256")

    # RMSNorm at d 4096: a decode step's rows and a long prefill's; the
    # fused add's library call is the add then the norm
    d = 4096
    for rows in (8, 4096):
        x, y, w = rn(rows, d), rn(rows, d), rn(d) * 0.1
        w1 = 1.0 + w
        cases.append((
            "rmsnorm", f"rows={rows} d={d}",
            lambda x=x, w=w: ops.rmsnorm(x, w),
            lambda x=x, w=w: ref.rmsnorm_ref(x, w),
            lambda x=x, w=w: ref.rmsnorm_ref(x.float(), w.float()),
            lambda x=x, w1=w1: F.rms_norm(x, (d,), weight=w1, eps=1e-6),
            nbytes(x, w, x), 4 * rows * d, "bf16"))
        cases.append((
            "add_rmsnorm", f"rows={rows} d={d}",
            lambda x=x, y=y, w=w: ops.add_rmsnorm(x, y, w),
            lambda x=x, y=y, w=w: ref.add_rmsnorm_ref(x, y, w),
            lambda x=x, y=y, w=w: ref.add_rmsnorm_ref(*f32(x, y, w)),
            lambda x=x, y=y, w1=w1: F.rms_norm(x + y, (d,), weight=w1,
                                               eps=1e-6),
            nbytes(x, y, w, x, x), 5 * rows * d, "bf16"))

    # mamba2-2.7b: 80 heads of P 64, N 128; the serving chunk (Q 16), two
    # lanes' ragged last chunks (Q 7) and the config's (two chunks of 256). mamba2-like magnitudes: dt in
    # [1e-3, 1e-1], A in [-80, -1], so the decays lie in (0, 1]
    H, P, N = 80, 64, 128
    for B, nc, Q in ((1, 1, 16), (2, 1, 7), (1, 2, 256)):
        dt = torch.rand((B, nc, Q, H), generator=g, device=dev) * 0.099 \
            + 0.001
        A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
        xdt = rn(B, nc, Q, H, P, dtype=torch.float32) * dt[..., None]
        cum_a = torch.cumsum(dt * A, dim=2)
        Br, Cr = rn(B, nc, Q, N, dtype=torch.float32), \
            rn(B, nc, Q, N, dtype=torch.float32)
        a = (xdt, cum_a, Br, Cr)
        y_bytes = xdt.numel() * 4 + B * nc * H * P * N * 4
        tri = Q * (Q + 1) // 2
        n_ops = 2 * B * nc * (N * tri + H * (P * tri + Q * N * P))
        cases.append((
            "ssd_intra", f"B={B} nc={nc} Q={Q} H={H} P={P} N={N}",
            lambda a=a: ops.ssd_intra(*a),
            lambda a=a: ref.ssd_intra_ref(*a),
            lambda a=a: ref.ssd_intra_ref(*a),
            None, nbytes(*a) + y_bytes, n_ops, "tf32"))

    # recurrentgemma-9b: lru width 4096; two lanes of a serving chunk, one
    # long prefill, and ragged widths at T 1 and T 37
    for B, T, W in ((2, 16, 4096), (1, 512, 4096), (3, 1, 1000),
                    (2, 37, 1000)):
        a_ = torch.rand((B, T, W), generator=g, device=dev) * 0.5 + 0.5
        bx = rn(B, T, W, dtype=torch.float32)
        h0 = rn(B, W, dtype=torch.float32)
        a = (a_, bx, h0)
        cases.append((
            "rglru_scan", f"B={B} T={T} W={W}",
            lambda a=a: ops.rglru_scan(*a),
            lambda a=a: ref.rglru_scan_ref(*a),
            lambda a=a: ref.rglru_scan_ref(*a),
            None, nbytes(*a) + nbytes(bx, h0), 2 * B * T * W, "fp32"))
    # the gated recurrence: two lanes of a serving chunk, a decode step at
    # b_max 8 and a long prefill in bf16, and one fp32 case; gate
    # pre-activations of unit scale, Lambda as the model initialises it
    for B, T, dtype in ((2, 16, bf), (8, 1, bf), (1, 512, bf),
                        (2, 16, torch.float32)):
        a = gated_inputs(B, T, g, dev, dtype)
        cases.append((
            "rglru_gated_scan",
            f"B={B} T={T} W=4096 {'bf16' if dtype == bf else 'fp32'}",
            lambda a=a: ops.rglru_gated_scan(*a),
            lambda a=a: ref.rglru_gated_scan_ref(*a),
            lambda a=a: ref.rglru_gated_scan_ref(*f32(*a)),
            None, nbytes(*a) + nbytes(a[0], a[6]), 15 * B * T * 4096, "fp32",
            {"chain": lambda a=a: eager_gated_scan(*a)}))
    return cases


def eager_gated_scan(ga, gi, x, lam, b_a, b_i, h0, scan=None):
    """The gated recurrence as the model ran it before the gated kernel:
    the gates op by op, then the scan kernel (or `scan`; one step of eager
    arithmetic at T 1, as its decode did), then the cast: some twenty
    launches."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    r = torch.sigmoid(ga.float() + b_a)
    i = torch.sigmoid(gi.float() + b_i)
    a = torch.exp(-8.0 * F.softplus(lam.float()) * r)
    bx = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * x.float())
    if x.shape[1] == 1:
        h = a[:, 0] * h0 + bx[:, 0]
        return h[:, None].to(x.dtype), h
    y, hT = (scan or ops.rglru_scan)(a, bx, h0)
    return y.to(x.dtype), hT


#: launch-floor cases also timed as 100 launches in one CUDA graph
GRAPH_CASES = {("rmsnorm", "rows=8 d=4096"), ("add_rmsnorm", "rows=8 d=4096"),
               ("decode_attention", "B=8 S=1024"),
               ("rglru_gated_scan", "B=8 T=1 W=4096 bf16")}

#: kernel -> (route, source, the TPU kernel it replaces, main-path case)
KERNELS = {
    "decode_attention": (
        "cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:83", "B=8 S=1024"),
    "paged_decode_attention": (
        "cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:139", "B=8 blocks=241"),
    "flash_attention": (
        "cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:61", "Tq=16 Tk=1024"),
    "paged_flash_attention": (
        "cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:61", "Tq=16 MB=64 bs=16"),
    "rmsnorm": (
        "cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm.py:25", "rows=8 d=4096"),
    "add_rmsnorm": (
        "cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm.py:25", "rows=8 d=4096"),
    "ssd_intra": (
        "cuda", "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:38",
        "B=1 nc=1 Q=16 H=80 P=64 N=128"),
    "rglru_scan": (
        "cuda", "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru_scan.py:31", "B=2 T=16 W=4096"),
    "rglru_gated_scan": (
        "cuda", "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru_scan.py:31", "B=2 T=16 W=4096 bf16"),
}


def run_kernels(dev):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    results = []
    for name, label, kern, plain, plain32, lib, n_bytes, n_ops, peak, \
            *extra in kernel_cases(dev):
        got = kern()
        torch.cuda.synchronize()
        want = plain32()
        err = max_err(got, want)
        if name == "add_rmsnorm" and not torch.equal(got[0], plain()[0]):
            raise AssertionError(f"add_rmsnorm {label}: the sum is not "
                                 f"bit for bit x + y")
        fp32 = (got[0] if isinstance(got, tuple) else got).dtype \
            == torch.float32
        b_ms, b_by = bound(n_bytes, n_ops, peak)
        r = dict(name=name, case=label, max_abs_err=err,
                 tol=f"{FP32_TOL} * max|plain|" if fp32
                 else f"{ATOL} + {RTOL} * |plain|",
                 ms=time_ms(kern, flush), plain_ms=time_ms(plain, flush),
                 library_ms=time_ms(lib, flush) if lib else None,
                 bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, ops=n_ops,
                 peak=f"{peak} {PEAK_FLOPS[peak] / 1e12} TFLOP/s")
        if name in ("rmsnorm", "add_rmsnorm"):
            r.update(host_us=host_us(kern), library_host_us=host_us(lib))
        if name.startswith("rglru"):
            # the plain versions loop over T in Python: fewer calls
            r.update(host_us=host_us(kern),
                     plain_host_us=host_us(plain, n=50, warmup=3))
        for key, fn in (extra[0] if extra else {}).items():
            r.update({f"{key}_ms": time_ms(fn, flush),
                      f"{key}_host_us": host_us(fn)})
        if (name, label) in GRAPH_CASES:
            r["graph_ms"], r["stream_ms"] = graph_ms(kern)
        emit("kernels", **r)
        results.append(r)
    return results


# ---------------------------------------------------------------------------
# phase 4: reference

#: arch -> (layers kept, prefill tokens, decode steps)
REFERENCE = {"granite-3-8b": (2, 64, 4), "mamba2-2.7b": (2, 300, 4),
             "recurrentgemma-9b": (3, 300, 4)}


def run_reference(dev, arch: str):
    """Full width, depth cut to one layer pattern: the kernels' path (bf16,
    card) against the plain path (fp32, CPU) with the same weights."""
    import dataclasses
    from repro_torch.config.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    layers, T, n_dec = REFERENCE[arch]
    cfg = dataclasses.replace(get_config(arch, "full"), num_layers=layers)
    m = build_model(cfg, torch.bfloat16, dev)
    params = m.init(0)
    m_cpu = build_model(cfg, torch.float32, "cpu")

    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.float().cpu()

    p_cpu = to_cpu(params)
    toks = torch.randint(0, cfg.vocab_size, (1, T + n_dec),
                         generator=torch.Generator().manual_seed(0))
    pos = torch.arange(T + n_dec, dtype=torch.int32)[None]
    outs = []
    ops.reset_launches()
    for model, p, d in ((m, params, dev), (m_cpu, p_cpu, "cpu")):
        cache = model.init_cache(1, 2 * T, prefill_chunk=T)
        lg, cache = model.prefill(p, toks[:, :T].to(d), pos[:, :T].to(d),
                                  cache, last_only=True)
        seq = [lg[0, -1]]
        for t in range(T, T + n_dec):
            lg, cache = model.decode_step(p, toks[:, t].to(d),
                                          pos[:, t].to(d), cache)
            seq.append(lg[0])
        outs.append(torch.stack(seq).float().cpu())
    got, want = outs
    launches = {k: n for k, n in ops.LAUNCHES.items() if n}
    if got.shape != (n_dec + 1, cfg.vocab_size) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"bad logits: shape {tuple(got.shape)}")
    n_rec = cfg.layer_kinds().count("recurrent")
    if n_rec and (launches.get("rglru_gated_scan") != n_rec * (1 + n_dec)
                  or "rglru_scan" in launches):
        raise AssertionError(f"{arch}: the gated RG-LRU kernel is not the "
                             f"recurrence of every forward: {launches}")
    rel = float((got - want).abs().max() / want.abs().max())
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    emit("reference", arch=arch, layers=layers, d_model=cfg.d_model,
         prefill_tokens=T, rel_max_err=rel, tol=5e-2,
         argmax_agreement=same, launches=launches)
    if rel > 5e-2:
        raise AssertionError(f"{arch}: kernel path vs fp32 plain path: "
                             f"rel err {rel}")
    del m, params, m_cpu, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=arch, rel_max_err=rel, argmax_agreement=same)


# ---------------------------------------------------------------------------
# phase 5: serving


def serve_prompts(arch: str):
    import numpy as np
    from repro_torch.config.registry import get_config

    vocab = get_config(arch, "full").vocab_size
    rng = np.random.RandomState(0)
    return [list(map(int, rng.randint(0, vocab, size=rng.randint(
        PROMPT_LO, PROMPT_HI + 1)))) for _ in range(FAMILIES[arch][0])]


def run_serve(arch: str, paged: bool, cuda_graphs: bool = True,
              depth: int = 0, beside: Optional[dict] = None):
    """Serve the family's prompts through `launch.serve.build_engine` (its
    graphs captured by `warmup` first), `depth` intervals dispatched ahead
    (DESIGN §14), and check the run. `beside`: the depth-0 run's figures,
    printed on the line. Returns (the emitted fields, the engine, the
    requests)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    n_req, path, attends, (fused, plain), per_forward = FAMILIES[arch]
    args = serve.build_parser().parse_args(
        SERVE_ARGS + ["--arch", arch] + (["--paged"] if paged else [])
        + ["--overlap-depth", str(depth)])
    t0 = time.perf_counter()
    eng = serve.build_engine(args, cuda_graphs=cuda_graphs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm = eng.graphs.stats()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    handles = [eng.submit(p) for p in serve_prompts(arch)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    s = eng.summary()
    allocator_full = eng.blocks.free_blocks == eng.blocks.num_blocks
    name = f"serve_{arch}_{'paged' if paged else 'contiguous'}" \
        + ("" if cuda_graphs else "_eager") \
        + (f"_overlap{depth}" if depth else "")
    n_int = len(eng.step_host_trace)
    caught = eng.graphs.capture_s - warm["capture_s"]
    fields = dict(summary=s, launches=launches, build_s=build_s,
                  serve_s=wall, intervals=n_int,
                  step_host_s_mean_without_captures=(
                      sum(eng.step_host_trace) - caught) / max(n_int, 1),
                  interval_s_mean=s["step_host_s_mean"]
                  + s["step_device_s_mean"],
                  graphs_at_warmup=warm, graphs=eng.graphs.stats(),
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                  tokens_out=eng.total_decoded,
                  allocator_full=allocator_full, overlap_depth=depth,
                  prefill_chunk=eng.prefill_chunk,
                  max_context=eng.max_context)
    if beside is not None:
        fields["depth0"] = beside
    emit(name, **fields)
    if s["finished"] != n_req:
        raise AssertionError(f"{name}: {s['finished']} of {n_req} "
                             f"requests finished")
    if eng.state_only and (s["preemptions"] != 0 or not allocator_full):
        raise AssertionError(f"{name}: a state-only family preempted "
                             f"({s['preemptions']}) or leaked blocks")
    for k in path + (ATTENTION[paged] if attends else ()):
        if launches[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched")
    other = [k for k in ATTENTION[not paged] if launches[k]]
    if other:
        raise AssertionError(f"{name}: the other layout's attention kernels "
                             f"launched: {other}")
    forwards = launches["rmsnorm"] // plain
    if (launches["rmsnorm"], launches["add_rmsnorm"]) != (
            plain * forwards, fused * forwards):
        raise AssertionError(
            f"{name}: norm launches {launches['add_rmsnorm']} fused + "
            f"{launches['rmsnorm']} plain are not {fused} + {plain} a "
            f"forward")
    for k, n in per_forward.items():
        if launches[k] != n * forwards:
            raise AssertionError(f"{name}: {launches[k]} launches of {k} "
                                 f"in {forwards} forwards, not {n} a "
                                 f"forward")
    if cuda_graphs and (not eng.graphs.enabled or any(
            st.graph is None for st in eng.graphs.steps.values())):
        raise AssertionError(f"{name}: a step ran without its graph")
    if eng.overlap_depth != depth or eng._inflight:
        raise AssertionError(f"{name}: depth {eng.overlap_depth}, "
                             f"{len(eng._inflight)} intervals left in flight")
    return fields, eng, handles


def request_sets(reqs) -> dict:
    """The finished, rejected and SLA-met request ids of a run."""
    return dict(
        finished=sorted(r.rid for r in reqs
                        if r.state.value == "finished" and not r.rejected),
        rejected=sorted(r.rid for r in reqs if r.rejected),
        sla_met=sorted(r.rid for r in reqs if r.sla_met))


def overlap_figures(fields) -> dict:
    s = fields["summary"]
    return dict(step_host_s_mean=s["step_host_s_mean"],
                step_device_s_mean=s["step_device_s_mean"],
                interval_s_mean=fields["interval_s_mean"],
                step_host_s_mean_without_captures=fields[
                    "step_host_s_mean_without_captures"],
                throughput_tok_s=s["throughput_tok_s"],
                tbt_ms_mean=s["tbt_ms_mean"], serve_s=fields["serve_s"])


def run_twin(arch: str, layout: str, runs: dict):
    """The port's simulator (`serving/sim.py`) on the serve runs'
    configuration: the same ServeConfig, prompt lengths, capped
    max_new_tokens, max_context and prefill chunk, prior-free telemetry,
    every arrival at 0 (the memory policy reads only length moments and
    counts). `runs`: overlap depth -> (the serve run's fields, its
    requests). Each depth's engine run must agree with the sim at that
    depth on TWIN and on the request sets; decode_steps and mean_batch are
    printed beside the engine's (the sim's batch trace also counts
    prefill-only intervals)."""
    from repro_torch.config.registry import get_config
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.launch import serve
    from repro_torch.serving.cost_model import CostModel, PROFILES
    from repro_torch.serving.request import Request
    from repro_torch.serving.sim import LengthDist, ServingSimulator

    cfg = get_config(arch, "full")
    lens = [len(p) for p in serve_prompts(arch)]
    out, bad = {}, {}
    for depth, (fields, reqs) in runs.items():
        args = serve.build_parser().parse_args(
            SERVE_ARGS + ["--arch", arch]
            + (["--paged"] if layout == "paged" else [])
            + ["--overlap-depth", str(depth)])
        ctx = fields["max_context"]
        sim = ServingSimulator(
            cfg, serve.serve_config(args), CostModel(cfg,
                                                     PROFILES[args.profile]),
            LengthDist(mean_in=sum(lens) / len(lens),
                       mean_out=float(args.max_new)),
            prefill_chunk=fields["prefill_chunk"], max_context=ctx)
        sim.tel = Telemetry()
        for i, n in enumerate(lens):
            # Engine.submit caps max_new_tokens at the context; mirror it
            sim.waiting.append(Request(
                rid=i, arrival_time=0.0, prompt_len=n,
                max_new_tokens=min(args.max_new, ctx - n - 1)))
        sim._all.extend(sim.waiting)
        t0 = time.perf_counter()
        res = sim.run()
        sim_s = time.perf_counter() - t0
        s = fields["summary"]
        eng = {k: s[k] for k in TWIN} | request_sets(reqs)
        twin = {k: getattr(res, k) for k in TWIN} | request_sets(sim._all)
        out[f"depth{depth}"] = dict(
            engine=eng, sim=twin, sim_s=sim_s,
            decode_steps=dict(engine=s["decode_steps"],
                              sim=res.decode_steps),
            mean_batch=dict(engine=s["mean_batch"], sim=res.mean_batch))
        bad.update({f"depth{depth} {k}": (eng[k], twin[k]) for k in eng
                    if eng[k] != twin[k]})
    emit(f"twin_{arch}_{layout}", **out)
    if bad:
        raise AssertionError(f"twin {arch} {layout}: the engine and the "
                             f"simulator disagree: {bad}")
    return out


def fill_cache(eng, seed: int) -> None:
    """Random K/V, positions and state wherever a request could look (the
    paged spare block's positions stay empty, the sentinel state zero)."""
    from repro_torch.models.backbone import STATE_KEYS

    g = torch.Generator(device=eng.device).manual_seed(seed)
    for k, v in eng.cache.items():
        if k == "pos":
            v.copy_(torch.randint(-1, eng.max_context, v.shape, generator=g,
                                  device=eng.device, dtype=v.dtype))
            if eng.paged:
                v[-1] = -1
        else:
            v.normal_(generator=g)
            if eng.paged and k in STATE_KEYS:
                v[:, eng.n_slots] = 0


def run_graph_check(eng, name: str):
    """Replay against eager run of the same step, bit for bit, from the
    same cache and inputs: decode at bucket 8 and a lane's full chunk, on
    random cache contents and inputs (distinct blocks and state slots)."""
    import numpy as np

    rng = np.random.RandomState(0)
    lane = ("chunk", 1, eng.prefill_chunk, -1 if eng.paged else eng.max_slots)
    checks = []
    for key in (("decode", 8), lane):
        st = eng.graphs.steps[key]
        fill_cache(eng, seed=len(checks))
        rows, T = st.inputs["tokens"].shape
        starts = rng.randint(T, eng.max_context - 2 * T, size=rows)
        host = {"tokens": rng.randint(0, eng.cfg.vocab_size, (rows, T)),
                "positions": starts[:, None] + np.arange(T)}
        if eng.paged:
            per = eng.max_blocks
            host["block_table"] = rng.permutation(
                eng.mem.num_blocks)[:rows * per].reshape(rows, per)
            host["slots"] = rng.permutation(eng.n_slots)[:rows]
        for k, v in host.items():
            eng._stage(st, k, v.astype(np.int64))
        start = {k: v.clone() for k, v in eng.cache.items()}
        want = st.run(eager=True).clone()
        want_cache = {k: v.clone() for k, v in eng.cache.items()}
        for k, v in start.items():
            eng.cache[k].copy_(v)
        del start
        got = st.run().clone()
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        cache_same = all(bool(torch.equal(v, want_cache[k]))
                         for k, v in eng.cache.items())
        del want_cache
        launch_us, device_ms = replay_times(st)
        checks.append(dict(key=list(key), logits_bit_equal=same,
                           cache_bit_equal=cache_same,
                           finite=bool(torch.isfinite(got).all()),
                           max_abs_diff=float((got - want).abs().max()),
                           replay_launch_us=launch_us,
                           replay_device_ms=device_ms))
    emit(f"graphs_{name}", checks=checks, **eng.graphs.stats())
    bad = [c for c in checks if not (c["logits_bit_equal"]
                                     and c["cache_bit_equal"]
                                     and c["finite"])]
    if bad:
        raise AssertionError(f"{name}: replay differs from eager: {bad}")
    return dict(checks=checks, **eng.graphs.stats())


def replay_times(st, reps: int = 10):
    """(host µs of `graph.replay()` with the device idle, device ms of one
    replay by CUDA events): medians over `reps` replays."""
    host, dev = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        t0 = time.perf_counter()
        st.graph.replay()
        host.append((time.perf_counter() - t0) * 1e6)
        e.record()
        torch.cuda.synchronize()
        dev.append(s.elapsed_time(e))
    return statistics.median(host), statistics.median(dev)


#: CUDA runtime calls that block the host on the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cudaMemset")
#: the one blocking call an interval may make: its retirement's event wait
READBACK = "cudaEventSynchronize"


def _device_span(ev, runtime):
    """(first start, last end) in µs of the device work that the runtime
    calls `runtime` launched (kernels, copies and memsets by correlation
    id; a graph launch's kernels carry the launch's id), or None."""
    corr = {e["args"]["correlation"] for e in runtime
            if "correlation" in e.get("args", {})}
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in ev
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
             and e.get("args", {}).get("correlation") in corr]
    if not spans:
        return None
    return min(a for a, _ in spans), max(b for _, b in spans)


def trace_interval(path: Path):
    """From a chrome trace holding two consecutive `interval` annotations
    (two step() calls): the CUDA runtime calls of the first, the blocking
    ones before its last (the retirement's wait), pageable copies, the
    share of its wall time the device was busy (union of kernel, memcpy
    and memset spans), and the device's gap between the last device work
    the first call launched and the first the second call launched."""
    ev = json.loads(path.read_text())["traceEvents"]
    ivs = sorted((e for e in ev if e.get("name") == "interval"
                  and e.get("cat") == "user_annotation"),
                 key=lambda e: e["ts"])

    def runtime_of(iv):
        t0, t1 = iv["ts"], iv["ts"] + iv["dur"]
        return sorted((e for e in ev if e.get("cat") in ("cuda_runtime",
                                                         "cuda_driver")
                       and t0 <= e.get("ts", -1) <= t1),
                      key=lambda e: e["ts"])

    iv = ivs[0]
    t0, t1 = iv["ts"], iv["ts"] + iv["dur"]
    rt = runtime_of(iv)
    names = [e["name"] for e in rt]
    syncs = [i for i, n in enumerate(names) if n in SYNC_CALLS]
    gpu = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in ev
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and t0 <= e.get("ts", -1) <= t1)
    busy, end = 0.0, t0
    for a, b in gpu:
        a, b = max(a, end), min(b, t1)
        if b > a:
            busy += b - a
            end = b
    counts = {}
    for n in names:
        counts[n] = counts.get(n, 0) + 1
    spans = [_device_span(ev, runtime_of(i)) for i in ivs[:2]]
    gap = spans[1][0] - spans[0][1] \
        if len(spans) == 2 and None not in spans else None
    return dict(
        wall_us=iv["dur"], runtime_calls=counts, traced=bool(rt),
        device_events=len(gpu),
        syncs_before_readback=[names[i] for i in syncs[:-1]],
        readback=names[syncs[-1]] if syncs else None,
        pageable_copies=sum(1 for e in ev if e.get("cat") == "gpu_memcpy"
                            and "HtoD (Pageable" in e.get("name", "")
                            and t0 <= e.get("ts", -1) <= t1),
        device_busy_share=busy / iv["dur"] if gpu else None,
        device_spans_us=spans, device_gap_us=gap,
        intervals_traced=len(ivs))


def run_profile(arch: str, paged: bool, depth: int = 0):
    """Two consecutive decode intervals at bucket 8 under `torch.profiler`,
    on a fresh engine of the serve runs' configuration with `depth`
    intervals dispatched ahead: 8 requests of one 16-token chunk each are
    prefilled and promoted, then pure decode intervals run, the third and
    fourth of them traced. The first traced call may block only in its
    retirement's event wait, and copies nothing from pageable memory; at
    depth k every traced call leaves k intervals in flight, so it retired
    an earlier interval than the one it dispatched. (Last of the script's
    phases: a process that has run the tracer launches slower after
    it.)"""
    import numpy as np
    from repro_torch.launch import serve

    eng = serve.build_engine(serve.build_parser().parse_args(
        SERVE_ARGS + ["--arch", arch] + (["--paged"] if paged else [])
        + ["--overlap-depth", str(depth)]))
    rng = np.random.RandomState(1)
    for _ in range(8):
        eng.submit(list(map(int, rng.randint(0, eng.cfg.vocab_size,
                                             size=16))), max_new_tokens=200)
    for _ in range(2000):
        if not (eng.waiting or eng.prefilling):
            break
        eng.step()
    if len(eng.active) != 8:
        raise AssertionError(f"profile: {len(eng.active)} active, not 8")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    OUT_DIR.mkdir(exist_ok=True)
    suffix = f"_overlap{depth}" if depth else ""
    path = OUT_DIR / f"trace_{arch}_decode_interval{suffix}.json"
    in_flight = []
    # traced intervals after two traced and dropped (the tracer's start-up)
    with torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
            on_trace_ready=lambda p: p.export_chrome_trace(str(path))) \
            as prof:
        for cycle in range(2):
            for _ in range(2):
                with torch.profiler.record_function("interval"):
                    eng.step()
                in_flight.append(len(eng._inflight))
            if cycle:
                # every launched kernel has run before the trace is
                # collected (not between the cycles: that would drain the
                # intervals in flight before the traced ones)
                torch.cuda.synchronize()
            prof.step()
    t = trace_interval(path)
    t["in_flight_after_each_step"] = in_flight
    emit("profile" + suffix, arch=arch, bucket=8, overlap_depth=depth,
         trace=str(path.relative_to(ROOT)), **t)
    if t["syncs_before_readback"] or t["pageable_copies"] \
            or t["readback"] != READBACK or t["intervals_traced"] != 2:
        raise AssertionError(f"profile{suffix}: the decode interval "
                             f"synchronises before its retirement's event "
                             f"wait, or copies pageable memory: {t}")
    if in_flight != [depth] * 4:
        raise AssertionError(f"profile{suffix}: {in_flight} intervals in "
                             f"flight after the steps, not {depth}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return t


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    logs = _build.build_all()
    ptxas = ptxas_table(logs)
    hmma = tf32_hmma_count("ssd_scan")
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas,
         ssd_tf32_hmma=hmma)
    spills = [r for r in ptxas if (r["kernel"].startswith("mma_")
                                   or r["lib"] in ("ssd_scan", "rglru_scan"))
              and (r["spill_stores"] or r["spill_loads"] or r["stack"])]
    mma = [r["kernel"] for r in ptxas
           if r["kernel"].startswith("mma_attention_kernel")]
    if spills or not any(k.endswith(", true>") for k in mma) \
            or not any(k.endswith(", false>") for k in mma):
        raise AssertionError(f"tensor-core attention, SSD or RG-LRU kernels "
                             f"spill or have a stack frame "
                             f"(or the paged or contiguous ones were not "
                             f"built): {spills}")
    if hmma == 0:
        raise AssertionError("the SSD kernel has no TF32 tensor-core "
                             "instruction in its SASS")

    kres = run_kernels(dev)
    refs = [run_reference(dev, arch) for arch in REFERENCE]
    serves, runs, launches, graphs, served = {}, {}, {}, {}, {}

    def tokens(key):
        return [r.output_tokens for r in served[key][1]]

    for arch in FAMILIES:
        layouts = {}
        for paged in (False, True):
            layout = "paged" if paged else "contiguous"
            fields, eng, reqs = run_serve(arch, paged)
            served[arch, layout] = (fields, reqs)
            layouts[layout] = fields["summary"]
            runs[f"{arch}_{layout}"] = fields
            for k, n in fields["launches"].items():
                launches[k] = launches.get(k, 0) + n
            graphs[f"{arch}_{layout}"] = run_graph_check(
                eng, f"{arch}_{layout}")
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        s_c, s_p = layouts["contiguous"], layouts["paged"]
        diff = {k: (s_c[k], s_p[k]) for k in STRUCTURAL if s_c[k] != s_p[k]}
        if diff:
            raise AssertionError(f"{arch}: structural counters differ "
                                 f"between cache layouts: {diff}")
        serves[arch] = layouts
    if any((n > 0) == (k in OFF_PATH) for k, n in launches.items()):
        raise AssertionError(f"a path kernel never launched, or an "
                             f"off-path one did: {launches}")
    # the same run with every step eager: the same tokens and counters,
    # and the host time the graphs took away
    arch, layout = PROFILED
    eager, eng, reqs = run_serve(arch, layout == "paged", cuda_graphs=False)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    diff = {k: (serves[arch][layout][k], eager["summary"][k])
            for k in STRUCTURAL
            if serves[arch][layout][k] != eager["summary"][k]}
    if [r.output_tokens for r in reqs] != tokens((arch, layout)) or diff:
        raise AssertionError(f"{arch} {layout}: the eager run's tokens or "
                             f"counters differ from the graph run's: {diff}")
    # dispatch-ahead (DESIGN §14): the depth-0 runs' tokens and counters
    overlap = {}
    for arch, layout in OVERLAPPED:
        zero, _ = served[arch, layout]
        fields, eng, reqs = run_serve(arch, layout == "paged",
                                      depth=OVERLAP_DEPTH,
                                      beside=overlap_figures(zero))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        for k, n in fields["launches"].items():
            launches[k] = launches.get(k, 0) + n
        diff = {k: (zero["summary"][k], fields["summary"][k])
                for k in STRUCTURAL
                if zero["summary"][k] != fields["summary"][k]}
        if [r.output_tokens for r in reqs] != tokens((arch, layout)) \
                or diff:
            raise AssertionError(f"{arch} {layout}: the depth-"
                                 f"{OVERLAP_DEPTH} run's tokens or "
                                 f"counters differ from depth 0's: {diff}")
        overlap[f"{arch}_{layout}"] = fields
        served[arch, layout, OVERLAP_DEPTH] = (fields, reqs)
    twins = {f"{arch}_{layout}": run_twin(arch, layout, {
        0: served[arch, layout],
        OVERLAP_DEPTH: served[arch, layout, OVERLAP_DEPTH]})
        for arch, layout in OVERLAPPED if arch in TWINNED}
    arch, layout = PROFILED
    profile = run_profile(arch, layout == "paged")
    profile_overlap = run_profile(arch, layout == "paged",
                                  depth=OVERLAP_DEPTH)

    summary = []
    for name, (route, source, replaces, case) in KERNELS.items():
        rows = [r for r in kres if r["name"] == name]
        main_row = next(r for r in rows if r["case"] == case)
        summary.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], case=main_row["case"],
            **{k: main_row[k] for k in ("host_us", "library_host_us",
                                        "plain_host_us", "chain_ms",
                                        "chain_host_us") if k in main_row},
            **next(({"graph_ms": r["graph_ms"], "stream_ms": r["stream_ms"],
                     "graph_case": r["case"]} for r in rows
                    if "graph_ms" in r), {})))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "ptxas": ptxas, "kernels": kres, "summary": summary,
         "reference": refs, "serve": runs, "launches": launches,
         "graphs": graphs, "profile": profile,
         "profile_overlap": profile_overlap, "serve_overlap": overlap,
         "twin": twins,
         "serve_eager": {f"{arch}_{layout}": eager}},
        indent=1))
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
