"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one JSON line each:

1. env       the card (nvidia-smi name and power limit), torch and CUDA
             versions; TF32 off for fp32 products.
2. build     nvcc builds every CUDA kernel of the port (one process per
             source, all at once). Registers and spill bytes per kernel
             instantiation, from ptxas; a spill or a stack frame in a bf16
             tensor-core attention kernel (the mma.sync and the wgmma
             designs, contiguous or paged), in any SSD kernel or in any
             RG-LRU kernel fails, and so does a build without either
             design's paged or contiguous instantiations or an SSD library
             whose SASS (cuobjdump) holds no TF32 tensor-core instruction
             (HMMA.1688.F32.TF32).
3. kernels   each of the 12 kernel entries against its plain PyTorch version
             (a prefill row named `<entry>_wgmma` where `split.route`
             gives the call the long-row wgmma kernel, with its `kernel`
             and host_us: the launch encodes two tensor maps; at the four
             routing shapes, ROUTING_SHAPES, both bf16 kernels named on
             the same call, mma_ms / wgmma_ms and their host µs; graph_ms
             for the encoder and granite's Tq-500 chunk too)
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
             (RMSNorm and the fused add 8 x 4096, decode B 8 S 1024, paged
             decode B 8, the Tq 16 chunks, gated RG-LRU B 8 T 1) also
             carry graph_ms: 100 launches captured in one CUDA graph,
             replay time / 100, beside stream_ms, the same 100 launches
             queued eagerly behind a spin kernel (warm L2 in both). The
             other decoder-only families add decode, paged decode and Tq
             16 chunks at hd 128 on G 9 / KV 4 (starcoder2-7b), G 1 / KV 40
             (qwen1.5-32b) and G 1 / KV 16 (qwen2-moe-a2.7b), rows filled to
             33-1024; a wrapped ring (mistral-nemo's sliding variant:
             window 256 on 271 slots, positions past 1024) in decode and a
             chunk; the norms at d 4608, 2048, 1024 and 8192. The VLM
             and enc-dec families add non-causal attention (`causal=
             False`, every key visible): seamless-m4t's encoder over 1024
             frames (Tq = Tk = 1024, 16 heads of 64, G 1) and its cross
             reads (a Tq 16 chunk and decode B 8 over 1024 keys), the
             VLM's (64 on 8 heads of 128: decode B 8 and a Tq 16 chunk
             over 1601 patches, a ragged last tile), and the paged cross
             read (each request's cross row one block of 1024 or 1601
             slots of the per-slot rows, tables = rows.view(B, 1)), each
             beside SDPA where one call computes it. The split form of
             RMSNorm (`rmsnorm_split`: a rank's share of mamba2-2.7b's
             gated norm, 2560 of d_inner 5120, at 8 and 16 rows; its two
             launches around the group's all-reduce), beside F.rms_norm
             over the whole rows; kernels_split_rows: whole rows cut in
             two simulated ranks, each half's sums made whole by adding
             the other's, equal to the rmsnorm kernel over the whole rows
             within 2e-2 (the reading with the sums not made whole
             printed). The sequence-sharded decode's two entries
             (`decode_attention_partial`, a data rank's slots stopped
             before the normalization, fp32 (O, m, l); `attention_combine`,
             R ranks' partials merged) at mistral-nemo-12b's shapes (32 on
             8 heads of 128, 256 and 2048 slots a rank, R 16 and 2) and
             recurrentgemma-9b's (16 on 1 of 256, 128 slots, R 16), in bf16
             and fp32, with graph_ms; the partial's library call aten's
             flash attention with its logsumexp (bf16, K/V expanded to H
             heads before the timing); the combine has none.
             kernels_tp_slices (the tp phase's part (c)): decode, paged
             decode and the Tq 16 / 500 chunks at granite-3-8b's TP-2
             shapes (`repro_torch.bench.tp_slices`): each rank's launch
             on its 16 query heads and 4 kv-heads against the same heads
             of the whole launch, and the non-causal launches at their
             TP-2 shapes (seamless's encoder, 8 of 16 heads at Tq = Tk =
             1024; the VLM's decode-step cross read, 32 heads on 4 over
             1601 patches, contiguous and paged), bit for bit in fp32 and
             in bf16 where both split the key axis alike, within 2e-2
             otherwise; recurrentgemma-9b's 8 of 16 heads on its kv-head
             of 256 gathered whole (decode B 8 over its 2048 window,
             contiguous and paged, and Tq 16 chunks), mamba2-2.7b's SSD
             term on 40 of 80 heads and the gated RG-LRU on 2048 of 4096
             channels (B 8 T 1, B 2 T 16), within 2e-2 (bf16) or 1e-4 of
             max|whole| (fp32); rank 0's serving-shape launches are timed
             as rows of this phase (case "TP-2 rank 0: ...").
4. reference per arch, full width with depth cut to one layer pattern
             (granite-3-8b, starcoder2-7b, mistral-nemo-12b,
             qwen2-moe-a2.7b and mamba2-2.7b 2 layers, qwen1.5-32b 1,
             recurrentgemma-9b 3):
             the kernels' path on the card in bf16 against the plain path
             on the CPU in fp32 with the same weights, over a prefill and a
             few decode steps (mamba2 and recurrentgemma prefill 300 tokens:
             two SSD chunks, the second padded); recurrentgemma's prefill
             and decode steps launch the gated RG-LRU kernel once a
             recurrent layer and the plain scan kernel never.
             cross_reference: seamless-m4t-medium (2 encoder + 2 decoder
             layers) and llama-3.2-vision-90b (4 self + 1 cross) at full
             width, every gate at 0.5: a first 16-token chunk with extras
             at the real lengths (1024 frames, 1601 patches), three more
             chunks and 4 decode steps, contiguous and paged against the
             fp32 plain path on the CPU, 5e-2 of max|logit|; the norm
             launches as counted below, and in a paged run no contiguous
             attention launch but the encoder's.
             sliding_reference: mistral-nemo-12b's sliding(window=256) at
             2 layers, 1040 tokens in 16-token chunks then 4 decode steps:
             the contiguous ring (271 slots, wrapped) and the paged pool
             on the card against the fp32 ring on the CPU, 5e-2.
5. serve_<arch>_contiguous / serve_<arch>_paged
             the engine at full width and depth (random weights from seed
             0) through `repro_torch.launch.serve.build_engine`, its CUDA
             graphs captured by `Engine.warmup` (every decode bucket and
             full-chunk lane shape; tail chunks at first use), for
             granite-3-8b (12 requests), starcoder2-7b (8),
             mistral-nemo-12b (6), qwen1.5-32b (4), qwen2-moe-a2.7b (8),
             mamba2-2.7b and recurrentgemma-9b (8 each),
             seamless-m4t-medium (12) and llama-3.2-vision-90b (8;
             the first n of one prompt stream; the VLM's depth cut to 16
             self + 4 cross layers, `DEPTH_CUTS`; each request's extras
             at the real length, gates at 0.5):
             prompts of 32-480 tokens, 32 new tokens, chunked prefill on 2
             lanes, policy `memory`, each path's kernel launches counted.
             Every request finishes, the structural counters agree across
             the two layouts, and mamba2 preempts nothing and ends with the
             allocator full. Paged runs attend through the block table
             only (paged decode and paged chunks, no contiguous attention
             launch); contiguous runs launch no paged kernel; every
             forward launches the fused add + RMSNorm and the plain RMSNorm
             its family's number of times (granite 80 + 1, starcoder2
             64 + 1, mistral-nemo 80 + 1, qwen1.5 128 + 1, qwen2-moe 48 + 1,
             mamba2 64 + 65, recurrentgemma 76 + 1, seamless 48 + 1 and
             its encoder's 1 + 23 once a first chunk, the cut VLM
             40 + 1), and recurrentgemma
             launches the gated
             RG-LRU kernel 26 times a forward and the plain scan kernel
             never (it is the TPU kernel's direct counterpart, checked in
             the kernels phase only). Every step is a graph replay, which
             adds the launches its capture recorded. Each line carries
             step_host_s_mean, step_device_s_mean (the readback wait, the
             TBT sample), their sum (the interval's wall time), build_s
             (model, engine, warmup) and the graph counts. Each engine is
             built alone, the one before it freed: qwen1.5-32b's 70.4 GB of
             weights leave room for one cache.
             sliding_mistral-nemo-12b-swa
             mistral-nemo-12b's sliding(window=256) through
             `build_engine`'s config argument, served in both layouts: the
             contiguous ring wraps (a request's context passes its 271
             slots), the counters agree across layouts; the requests with
             equal tokens are counted.
6. graphs_<arch>_<layout>
             on each serve run's engine: decode at bucket 8 and a lane's
             full chunk, from random cache contents and inputs, replayed
             and run eagerly (and, for the families with extras, a lane's
             first chunk with random extras): logits and cache bit for
             bit equal; the
             graph count, capture seconds and the shared pool's bytes. The
             cache's copies stay in host memory where two do not fit
             beside the weights (qwen1.5-32b).
7. (none: granite's contiguous run served again eager was dropped for
             the time of tp (d); an engine on graphs against one with
             `cuda_graphs=False` token for token is a card test,
             tests/test_torch_cuda.py, and phase 6 holds every replay
             against its eager run bit for bit)
8. serve_<arch>_<layout>_overlap2
             granite-3-8b in both layouts and recurrentgemma-9b paged
             served again on graphs with two intervals dispatched ahead
             (`--overlap-depth 2`, DESIGN §14): the depth-0 run's tokens
             bit for bit and its structural counters; each line carries
             its host, device and interval means and tokens/s with the
             depth-0 run's beside them (`depth0`).
9. twin_<arch>_<layout> (granite-3-8b, qwen2-moe-a2.7b,
             seamless-m4t-medium)
             the port's simulator (`serving/sim.py`) on the same
             ServeConfig, prompt lengths, capped max_new_tokens,
             max_context and prefill chunk, prior-free telemetry, every
             arrival at 0, at depth 0 and 2: admitted, preemptions,
             oom_events, rejected, the finished, rejected and SLA-met sets,
             sla_requests_met and goodput_tokens equal the engine's at the
             same depth (qwen2-moe at depth 0); decode_steps and
             mean_batch printed beside.
10. prefix_reference
             (run after phase 4) granite-3-8b at 2 layers, full width,
             bf16, paged: request B reads request A's 16 system-prompt
             blocks through its table and prefills only its suffix; its
             last logits within 5e-2 of max|logit| of B prefilled whole.
11. tiers_granite-3-8b_recompute / _swap / _swap_overlap2
             the memory tiers (DESIGN §11) through
             `repro_torch.bench.kv_swap.serve_waves`: granite-3-8b
             paged, full width, the serve flags with `--policy static
             --pool-tokens 1536`; swap adds `--swap-space 256 --preempt
             auto`, once more at depth 2. All 12 requests finish, the
             allocator and host pool end full, only the paged attention
             kernels launch; recompute preempts and never swaps, swap
             swaps out at least once and swaps every victim back in;
             depth 2 gives depth 0's tokens and counters. Wrappers set on
             the engine's `_swap_out` / `_swap_in_next` from outside hold
             each swap round trip's K, V and pos rows bit for bit.
             tiers_granite-3-8b_prefix_off / _on / _prefix
             prefix sharing (DESIGN §10) through
             `bench.prefix_caching`: the shared-system-prompt stream in
             5 waves (16 requests), pool 8192: the hit rate and hit
             tokens equal the simulator's, no block is copied, prefill
             tokens fall by exactly the hit tokens; TTFT and the share
             of requests with equal tokens are printed.
             twin_tiers_granite-3-8b
             each tier run against the port's simulator on the same
             stream: TWIN, the swap counters and the request sets.
             Predictions (the simulator's) are printed beside.
12. profile, profile_overlap2
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
13. profile_swap
             the depth-0 swap run's engine serves its prompts again; its
             first swap-out and swap-in intervals under `torch.profiler`,
             the swap calls annotated from outside: no blocking CUDA
             call and no pageable copy from them, the intervals' one
             blocking call the retirement's event wait; the device time
             of the swap's copies per swapped block.
14. audit    (run after the serve runs of phase 5 and their graph checks,
             before the sliding runs) the port's flight rules
             (`repro_torch.analysis`): the AST rules over this checkout
             with the port's allowlist; the dispatch-level graph audit
             of every registry arch at reduced width in bf16 on the card
             (`graph_audit.card_config`: starcoder2-7b at head_dim 32),
             model functions and both layouts' engine steps, each step
             captured once; granite-3-8b's two served engines audited at
             full width (every step they hold traced, each decode bucket
             run twice through `Engine._step`: no build and no capture
             more than one a key); and granite's prompts served again on
             its warm contiguous engine with
             `torch.cuda.set_sync_debug_mode("error")` over every
             interval (off only for a first-use capture, whose interval
             is counted apart). Findings per rule, steps, aten ops,
             captures against distinct keys, covered intervals, seconds;
             any finding fails.

15. tp      (after the serve runs, their engines released) tensor-parallel
             serving (DESIGN §12) at full width in bf16: granite-3-8b,
             and one arch of each other family (`TP_MORE`:
             qwen2-moe-a2.7b, seamless-m4t-medium, llama-3.2-vision-90b at
             its DEPTH_CUTS, mamba2-2.7b and recurrentgemma-9b, whose
             single kv-head takes the head_dim fallback at m = 2). (a)
             tp_nccl_run /
             tp_nccl_one_rank: a (1, 1) mesh over NCCL, the serve flags,
             granite in both layouts and the others paged, on CUDA graphs
             with the all-reduces captured (`run_serve`'s checks): tokens
             and structural counters of the no-mesh runs bit for bit; the
             replay checks of phase 6 with each replay's device ms beside
             the no-mesh engine's; each engine's bucket-8 decode step (and
             a first chunk with extras) run once under the graph audit's
             `OpTrace`, its all-reduces and gathers equal to the layout's
             counts (`graph_audit.allreduces`, `gathers`; mamba2's forward
             launches `rmsnorm_split` 64 times and the plain norm once);
             the graph audit of the reduced one-rank mesh engines of
             `graph_audit.MESH_ARCHS` on the same group (every step's
             all-reduces and gathers against the layout's). (b)
             tp_gloo_arch / tp_gloo_two_ranks: a (1, 2) mesh, two gloo
             ranks on the one card (`launch.mesh.spawn_ranks`), each
             rank's weights drawn cut (`model.init_shard`), eager (gloo's
             collectives cannot be captured; NCCL refuses two ranks on one
             card), static policy, 4 prompts of 32-96 tokens, 16 new,
             granite and qwen2-moe in both layouts, the cross families
             paged with extras at the real lengths, mamba2 and
             recurrentgemma paged: both ranks decode the
             same tokens; at a cut depth (TP_PROBE_CUTS, full width) the
             first decode step's logits within TP_LOGIT_TOL of max|logit|
             of the single-device bf16 step on the same weights and
             inputs, and the same model with one all-reduce dropped (a
             planted fault: granite's last MLP, qwen2-moe's last layer's
             experts, the cross families' last cross `wo`, mamba2's last
             `out_proj`, recurrentgemma's last recurrent `w_out`) beyond
             it; mamba2's gated norm held by a layer check (a rank's
             normed channels against the whole norm's slice, the reading
             with its all-reduce dropped printed); the
             cross families held at TP_PROBE_ENC_LEN cross keys and
             printed at the real length; qwen2-moe on the single device's
             replayed expert picks, the picks that differed before the
             replay counted; the single device's own spread beside; a
             full-depth probe's all-reduces and gathers traced against
             the layout's; finished, model_shards 2 (mamba2 1) and the
             pool at that many times the per-chip tokens; the counters and request sets of the port's
             simulator at mesh_shape (1, 2); the kernels of the layout
             launched and the norms a forward (a first chunk's encoder
             taken off); weights a rank beside the whole model's; interval
             times beside the
             card's name and power limit (a correctness path: gloo copies
             each all-reduce through the host). Every new line carries its
             seconds. (d) tp_layout / tp_seq: the layouts the port once
             refused, each probe on the first ranks of one spawn of 16
             gloo ranks on the one card, eager, at full width and a cut depth: starcoder2-7b's
             36 query heads on a (1, 8) mesh (4 layers; the kv-heads on the
             head_dim fallback, q gathered a layer) and
             llama-3.2-vision-90b's cross K/V on the fallback on (1, 16)
             (4 self + 1 cross layers, 16 cross keys, gates 0.5): the
             prefill's last and the first decode step's logits within
             TP_LOGIT_TOL of max|logit| of the single device's, the
             planted fault beyond it (the q gather replaced by the rank's
             own columns; the cross slab read without its gather), every
             rank's tokens equal, the probe's all-reduces and gathers the
             layout's; the sequence-sharded decode on a (2, 1) mesh:
             mistral-nemo-12b `sliding` at 4 layers, batch 1, its ring
             prefilled on one device until it wraps, cut into the two data
             ranks' slots by `cache_specs(seq_shard=True)`, 16 decode steps
             through `decode_attention_partial`, one all-gather over "data"
             and `attention_combine` a layer, within TP_LOGIT_TOL of the
             single device's steps on the whole ring (the window of 4096
             on 4352 slots, 2176 a rank), its fault (each rank combines
             its own partial only) beyond it; the ranks' tokens
             equal, a step's collectives the layout's. Its launches are
             the new kernels' on the path. tp (b) no longer serves
             granite on the single device beside the two ranks (its
             full-depth readings were printed, not held).
16. train   (after the serve runs, their engines released) the training
             path (`repro_torch.training`), which runs no kernel (the JAX
             package's training forward reaches no Pallas kernel; the
             port's takes plain differentiable ops): train_reduced, three
             steps of `make_train_step` for each of the six families
             (granite-3-8b, qwen2-moe-a2.7b, mamba2-2.7b, recurrentgemma-9b,
             llama-3.2-vision-90b with its gates at 0.5,
             seamless-m4t-medium) reduced in fp32, TF32 off, on the card
             and on the CPU from the same params and batches: every loss
             within rtol 1e-4, no kernel launched. train_<arch>: through
             `train_loop.train` in bf16 with fp32 moments, remat, B 8,
             T 256, lr 3e-4, warmup 2, on MarkovData: granite-3-8b at full
             width cut to 16 of its 40 layers (the whole model and its
             AdamW state, 12 bytes a parameter, need 98 GB) for 20 steps,
             and mamba2-2.7b whole for 10. Every loss finite, the mean of
             the last 5 below the mean of the first 5, and at step 1 every
             param leaf's gradient (each layer's slice of a stacked leaf)
             finite with a non-zero norm; the median
             step time (CUDA events), tokens/s, peak memory (and the
             bytes allocated once the params are made, before the AdamW
             state), and the model FLOP rate (`train_flops`) as a share of
             the card's dense bf16 peak, beside the card's name and power
             limit.
17. dryrun  the dry run (`repro_torch.launch.dryrun.run_one`, one rank's
             step on the meta device): (a) dryrun_predicted: the two
             full-width training runs of the train phase (granite-3-8b on
             16 of 40 layers, mamba2-2.7b whole; bf16, fp32 moments, B 8,
             T 256, remat) reckoned on a (1, 1) mesh, their predicted
             peak within 5% of the measured one and the part above the
             state (params and moments) within 25%; (b) dryrun_fit: the
             whole granite-3-8b's rows at B 8, T 256 on (1, 1), (1, 2),
             (2, 1) and (1, 8), printed (bytes a rank, fits the card's 80
             GB or not); (c) dryrun_one_rank: one training step of
             granite-3-8b at full width cut to 4 layers on a (1, 1) NCCL
             group (the autograd collectives, traced in the forward and
             the backward) against the no-group step: the loss and every
             gradient bit for bit.
18. timing  the seconds of each stretch of phases (build, kernels,
             references, serve, audit, sliding, eager_overlap,
             twins_tiers, profiles, tp, tp_layouts, train, dryrun) and
             their total,
             from the kernels' build to the end of the dry run.

Then the card's name and power limit, the `{"kernels": [...]}` summary,
and as the last line `{"ok": true, "device": {...}}`. Any failure raises:
the script exits non-zero and prints no result. It also refuses to run
without a GPU or outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
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
#: cuts of the serve flags where an arch's weights leave too little of the
#: card: qwen1.5-32b's 65.6 GiB leave 13.5 GiB. Its contiguous cache of
#: 8 + 2 rows of 1024 tokens (12.5 GiB) does not fit beside the steps'
#: buffers, nor do 4 + 2 rows (7.5 GiB) beside the two lanes' gathered
#: rows (2.5 GiB in the graph pool), so it serves b_max 2 (4 rows, 5 GiB)
#: in both layouts
SERVE_CUTS = {"qwen1.5-32b": ["--b-max", "2"]}


def serve_args(arch: str):
    """chip_smoke's serve flags for `arch`, its cut included."""
    return SERVE_ARGS + ["--arch", arch] + SERVE_CUTS.get(arch, [])


#: arch -> (requests served (fewer than granite's 12 where a family's runs
#: are long: qwen1.5-32b decodes at b_max 2, mistral-nemo serves three
#: pairs; the first n of the same prompt stream), kernels its main path
#: must launch in both
#: layouts, whether it attends (the layout's decode and chunk kernels are
#: then added), (fused add + RMSNorm, plain RMSNorm) launches per forward,
#: other kernels' launches per forward, prefill chunks and decode steps
#: alike)
FAMILIES = {
    "granite-3-8b": (12, ("rmsnorm", "add_rmsnorm"), True, (80, 1), {}),
    "starcoder2-7b": (8, ("rmsnorm", "add_rmsnorm"), True, (64, 1), {}),
    "mistral-nemo-12b": (6, ("rmsnorm", "add_rmsnorm"), True, (80, 1), {}),
    "qwen1.5-32b": (4, ("rmsnorm", "add_rmsnorm"), True, (128, 1), {}),
    "qwen2-moe-a2.7b": (8, ("rmsnorm", "add_rmsnorm"), True, (48, 1), {}),
    "mamba2-2.7b": (8, ("ssd_intra", "rmsnorm", "add_rmsnorm"), False,
                    (64, 65), {}),
    "recurrentgemma-9b": (8, ("rglru_gated_scan", "rmsnorm", "add_rmsnorm"),
                          True, (76, 1),
                          {"rglru_gated_scan": 26, "rglru_scan": 0}),
    # 12 decoder + 12 cross layers (the encoder's norms: FIRST_CHUNK)
    "seamless-m4t-medium": (12, ("rmsnorm", "add_rmsnorm"), True, (48, 1),
                            {}),
    # 16 self + 4 cross layers (DEPTH_CUTS)
    "llama-3.2-vision-90b": (8, ("rmsnorm", "add_rmsnorm"), True, (40, 1),
                             {}),
}
#: kernels no FAMILIES serve run launches: the TPU kernel's direct
#: counterpart, which the model's gated entry replaced on the path. The
#: long-row kernel through the block table is on it: starcoder2's paged
#: mixed steps pad each lane to the 16-token chunk, 144 rows a kv head.
OFF_PATH = ("rglru_scan",)
#: attention kernels by layout (paged?): (decode, chunk)
ATTENTION = {False: ("decode_attention", "flash_attention"),
             True: ("paged_decode_attention", "paged_flash_attention")}
STRUCTURAL = ("decode_steps", "mean_batch", "admitted", "preemptions",
              "prefill_tokens", "finished")
#: the serve run whose decode interval is traced
PROFILED = ("granite-3-8b", "contiguous")
#: serve runs served again with two intervals dispatched ahead (DESIGN §14)
OVERLAPPED = (("granite-3-8b", "contiguous"), ("granite-3-8b", "paged"),
              ("recurrentgemma-9b", "paged"))
OVERLAP_DEPTH = 2
#: the engine-vs-simulator counters (tests/test_differential.py
#: `assert_parity`); the finished, rejected and SLA-met sets are compared too
TWIN = ("admitted", "preemptions", "oom_events", "rejected",
        "sla_requests_met", "goodput_tokens")
#: serve runs held against the port's simulator (in both layouts, at
#: every depth served)
TWINNED = ("granite-3-8b", "qwen2-moe-a2.7b", "seamless-m4t-medium")
#: depth cuts of serve runs whose whole model does not fit the card:
#: llama-3.2-vision-90b's 80 self + 20 cross layers (175 GB in bf16) cut
#: to 16 + 4 (38 GB), a cross layer after every 4 self layers as whole
DEPTH_CUTS = {"llama-3.2-vision-90b": dict(num_layers=16,
                                           num_cross_layers=4)}
#: launches a first chunk (the step that carries a request's extras) adds
#: to its forward's: seamless-m4t's encoder, 12 layers (the first ln1
#: plain, 23 fused norms, 12 non-causal flash calls, in either layout, on
#: the long-row kernel)
FIRST_CHUNK = {"seamless-m4t-medium": {"rmsnorm": 1, "add_rmsnorm": 23,
                                       "flash_attention": 12,
                                       "flash_attention_wgmma": 12}}
#: the sliding-window run: mistral-nemo-12b's `sliding(window=...)` through
#: `build_engine`'s config argument, served like FAMILIES' runs; its
#: contiguous ring (window + chunk - 1 slots) wraps under the prompts
SLIDING = ("mistral-nemo-12b", 256)
#: the serve run whose engines the audit phase reuses: their steps audited
#: at full width in both layouts, and the contiguous engine's prompts
#: served again under the CUDA sync debug mode
AUDITED = "granite-3-8b"


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


def max_err(got, want, bf16: bool = False) -> float:
    """Max abs error over the outputs (a tensor or a tuple of them); raises
    when an element is outside the tolerance: atol + rtol|want| for a bf16
    output (or any output of a call on bf16 inputs, `bf16`: the partial
    flash decode's fp32 partials), FP32_TOL * max|want| for an fp32 one."""
    if isinstance(got, tuple):
        return max(max_err(g, w, bf16) for g, w in zip(got, want))
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.float32 and not bf16:
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
KERNEL_NAMES = ("mma_attention_kernel", "mma_combine_kernel",
                "wg_attention_kernel", "decode_kernel", "flash_kernel",
                "rmsnorm_kernel", "sumsq_kernel", "scale_kernel",
                "ssd_kernel", "rglru_kernel")


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
    from repro_torch.kernels import ops, ref, split
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, dtype=bf):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def f32(*a):
        return [t.float() if t.is_floating_point() else t for t in a]

    cases = []

    def ring_pos(B, S, Tq):
        """(q_pos (B, Tq), k_pos (B, S)) of a wrapped ring of S slots: row
        b's last query at position 1100 + 37 b, slot s holding the newest
        position <= it that is s mod S."""
        last = 1100 + 37 * torch.arange(B, dtype=torch.int32, device=dev)
        ar = torch.arange(S, dtype=torch.int32, device=dev)
        kp = last[:, None] - (last[:, None] - ar) % S
        qp = last[:, None] - Tq + 1 + torch.arange(Tq, dtype=torch.int32,
                                                   device=dev)
        return qp, kp

    def decode(B, S, H, KV, hd, label, window=0, fill=None, ring=False):
        """One query per row at position q_pos over an S-slot ring row; or,
        with `fill`, row b filled to fill[b] slots (the rest empty) and its
        query at fill[b] - 1; or, with `ring`, a wrapped ring (`ring_pos`).
        The bound counts the visible slots' K/V and every slot's k_pos."""
        q, k, v = rn(B, H, hd), rn(B, S, KV, hd), rn(B, S, KV, hd)
        ar = torch.arange(S, dtype=torch.int32, device=dev)
        if ring:
            qp, kp = ring_pos(B, S, 1)
            qp = qp[:, 0]
        elif fill is None:
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
            nbytes(q, qp, kp, q) + int(vis.sum()) * KV * hd * 2 * 2,
            4 * hd * H * int(vis.sum()), "bf16"))

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
            routed("paged_flash_attention", q, hd, Tq * (H // KV),
                   tables.shape[1] * kpool.shape[1], kpool.shape[1]), label,
            lambda a=a: ops.paged_flash_attention(*a),
            lambda a=a: ref.paged_flash_attention_ref(*a),
            lambda a=a: ref.paged_flash_attention_ref(*f32(*a)),
            None, read + nbytes(q, qp, q), 4 * hd * H * n_vis, "bf16"))

    def routed(name, q, hd, rows, Tk, bs=None):
        """The entry's row name: with "_wgmma" where `split.route` gives the
        call the long-row kernel."""
        return name + ("_wgmma" if split.route(q.dtype, hd, rows, Tk, bs)
                       == "wgmma" else "")

    def both_kernels(label, fn):
        """At the routing shapes, both bf16 kernels named on the same call
        (`fn(kernel)`), timed as the row's extra calls (mma_ms, wgmma_ms and
        their host µs)."""
        if label not in ROUTING_SHAPES:
            return ()
        return ({k: lambda k=k: fn(k) for k in ("mma", "wgmma")},)

    def flash(Tq, H, KV, hd, label, window=0, ring=0):
        """A chunk of Tq queries ending at position 496 (or Tq) against a
        1024-slot cache row filled up to it (slots past it empty); or, with
        `ring`, the last Tq queries of a wrapped ring of that many slots
        (`ring_pos`). The bound counts the K/V and k_pos of the slots some
        query sees."""
        Tk = ring or 1024
        q, k, v = rn(1, Tq, H, hd), rn(1, Tk, KV, hd), rn(1, Tk, KV, hd)
        if ring:
            qp, kp = ring_pos(1, Tk, Tq)
        else:
            end = max(496, Tq)
            qp = torch.arange(end - Tq, end, dtype=torch.int32,
                              device=dev)[None]
            ar = torch.arange(Tk, dtype=torch.int32, device=dev)
            kp = torch.where(ar < end, ar, -1)[None]
        mask = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None])
        if window:
            mask &= kp[:, None, :] > qp[:, :, None] - window
        mask = mask[:, None]
        seen = int(mask.any(2).sum())
        a = (q, k, v, qp, kp)
        cases.append((
            routed("flash_attention", q, hd, Tq * (H // KV), Tk), label,
            lambda a=a: ops.flash_attention(*a, window=window),
            lambda a=a: ref.flash_attention_ref(*a, window=window),
            lambda a=a: ref.flash_attention_ref(*f32(*a), window=window),
            lambda q=q, k=k, v=v, m=mask: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=m, enable_gqa=True),
            nbytes(q, q, qp) + seen * (KV * hd * 2 * 2 + 4),
            4 * hd * H * int(mask.sum()), "bf16",
            *both_kernels(label, lambda kern, a=a: flash_attention_cuda(
                *a, window=window, _kernel=kern))))

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

    # the other decoder-only families at hd 128: starcoder2-7b (36 heads on
    # 4 kv heads, G 9), qwen1.5-32b (MHA on 40 kv heads) and qwen2-moe (MHA
    # on 16); rows filled to 33-1024, as a serving batch at max_context
    fill = [33, 100, 160, 240, 384, 512, 777, 1024]
    for H, KV in ((36, 4), (40, 40), (16, 16)):
        g_kv = f"G={H // KV} KV={KV}"
        decode(8, 1024, H, KV, 128, f"B=8 S=1024 fill=33-1024 {g_kv}",
               fill=fill)
        paged(H, KV, 128, f"B=8 fill=33-1024 {g_kv} blocks=", lens=fill)
        flash(16, H, KV, 128, f"Tq=16 Tk=1024 {g_kv}")
        paged_chunk(16, H, KV, 128, f"Tq=16 MB=64 bs=16 {g_kv}")
    # mistral-nemo-12b's sliding variant (32 heads on 8, window 256) on the
    # ring a 16-token chunk needs (256 + 16 - 1 slots), wrapped: positions
    # past 1024, each slot holding the newest position of its residue
    decode(8, 271, 32, 8, 128, "B=8 S=271 window=256 ring", window=256,
           ring=True)
    flash(16, 32, 8, 128, "Tq=16 S=271 window=256 ring", window=256,
          ring=271)

    def noncausal(B, Tq, Tk, H, KV, hd, label, encoder=False):
        """Non-causal attention over Tk keys, every key visible: the
        encoder's self-attention (`encoder`: queries and keys at positions
        0..Tk-1, Tq = Tk) or a cross-attention read (queries and keys all
        at position 0). The bound counts every key's K/V and k_pos."""
        q, k, v = rn(B, Tq, H, hd), rn(B, Tk, KV, hd), rn(B, Tk, KV, hd)
        if encoder:
            kp = torch.arange(Tk, dtype=torch.int32, device=dev).repeat(B, 1)
            qp = kp
        else:
            qp = torch.zeros((B, Tq), dtype=torch.int32, device=dev)
            kp = torch.zeros((B, Tk), dtype=torch.int32, device=dev)
        a = (q, k, v, qp, kp)
        cases.append((
            routed("flash_attention", q, hd, Tq * (H // KV), Tk), label,
            lambda a=a: ops.flash_attention(*a, causal=False),
            lambda a=a: ref.flash_attention_ref(*a, causal=False),
            lambda a=a: ref.flash_attention_ref(*f32(*a), causal=False),
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                enable_gqa=True),
            nbytes(q, q, qp, k, v, kp), 4 * hd * H * B * Tq * Tk, "bf16",
            *both_kernels(label, lambda kern, a=a: flash_attention_cuda(
                *a, causal=False, _kernel=kern))))

    def paged_cross(B, Tq, Tk, H, KV, hd, label):
        """The paged cross read: B requests' cross K/V rows of 13 slots
        (the engine's 10 state slots, padded), each row one block of Tk
        keys (tables = rows.view(B, 1)), an all-zero position map."""
        N = 13
        kpool, vpool = rn(N, Tk, KV, hd), rn(N, Tk, KV, hd)
        rows = torch.randperm(N - 1, generator=g, device=dev)[:B]
        tables = rows.to(torch.int32).view(B, 1)
        kpos = torch.zeros((N, Tk), dtype=torch.int32, device=dev)
        q = rn(B, Tq, H, hd)
        qp = torch.zeros((B, Tq), dtype=torch.int32, device=dev)
        a = (q, kpool, vpool, qp, kpos, tables)
        cases.append((
            routed("paged_flash_attention", q, hd, Tq * (H // KV), Tk, Tk),
            label,
            lambda a=a: ops.paged_flash_attention(*a, causal=False),
            lambda a=a: ref.paged_flash_attention_ref(*a, causal=False),
            lambda a=a: ref.paged_flash_attention_ref(*f32(*a),
                                                      causal=False),
            None, nbytes(q, q, qp, tables) + B * Tk * (KV * hd * 2 * 2 + 4),
            4 * hd * H * B * Tq * Tk, "bf16"))

    # seamless-m4t-medium (16 heads of 64 on 16 kv heads): the encoder over
    # 1024 audio frames, and the decoder's cross-attention to them, a 16-
    # token chunk and a decode step at bucket 8, contiguous and paged;
    # llama-3.2-vision-90b (64 heads of 128 on 8): cross-attention to 1601
    # image patches (a ragged last tile), decode at bucket 8 and a chunk
    noncausal(1, 1024, 1024, 16, 16, 64, "encoder Tq=Tk=1024 hd=64 G=1",
              encoder=True)
    noncausal(1, 16, 1024, 16, 16, 64, "cross Tq=16 Tk=1024 hd=64 G=1")
    noncausal(8, 1, 1024, 16, 16, 64, "cross B=8 Tq=1 Tk=1024 hd=64 G=1")
    noncausal(8, 1, 1601, 64, 8, 128, "cross B=8 Tq=1 Tk=1601 G=8")
    noncausal(1, 16, 1601, 64, 8, 128, "cross Tq=16 Tk=1601 G=8")
    paged_cross(8, 1, 1024, 16, 16, 64,
                "cross B=8 Tq=1 bs=1024 hd=64 G=1")
    paged_cross(8, 1, 1601, 64, 8, 128, "cross B=8 Tq=1 bs=1601 G=8")
    paged_cross(1, 16, 1601, 64, 8, 128, "cross Tq=16 bs=1601 G=8")

    # the sequence-sharded decode: a data rank's slots of a batch-1 cache,
    # every slot inside the window: mistral-nemo-12b's 32 heads on 8 of
    # 128 at 256 and 2048 slots a rank (its 4096 window over data 16 and
    # 2) and recurrentgemma-9b's 16 on 1 of 256 at 128 (2048 over 16); the
    # partial in bf16 and fp32, and the combine of that many ranks'
    # partials. The partial's library call returns the logsumexp beside
    # the normalized output (the same function), on K/V expanded to the H
    # heads before the timing (it takes no GQA): aten's flash attention in
    # bf16, its memory-efficient attention in fp32 (flash runs 16-bit
    # only). No PyTorch call merges partials by their logsumexp: the
    # combine has none.
    for H, KV, hd, S, R_, win in SEQ_CASES:
        for dt in (bf, torch.float32):
            tag = "bf16" if dt == bf else "fp32"
            q, k, v = rn(1, H, hd, dtype=dt), rn(1, S, KV, hd, dtype=dt), \
                rn(1, S, KV, hd, dtype=dt)
            qp = torch.full((1,), 9000, dtype=torch.int32, device=dev)
            kp = (9000 - S + torch.arange(S, dtype=torch.int32,
                                          device=dev))[None]
            a = (q, k, v, qp, kp)
            G = H // KV
            kx = k.transpose(1, 2).repeat_interleave(G, 1).contiguous()
            vx = v.transpose(1, 2).repeat_interleave(G, 1).contiguous()
            if dt == bf:
                lib = lambda q=q, kx=kx, vx=vx: \
                    torch.ops.aten._scaled_dot_product_flash_attention(
                        q[:, :, None], kx, vx)[:2]
            else:
                lib = lambda q=q, kx=kx, vx=vx: \
                    torch.ops.aten._scaled_dot_product_efficient_attention(
                        q[:, :, None], kx, vx, None, True)[:2]
            cases.append((
                "decode_attention_partial",
                f"B=1 S={S} H={H} KV={KV} hd={hd} {tag}",
                lambda a=a, w=win: ops.decode_attention_partial(*a, window=w),
                lambda a=a, w=win: ref.decode_attention_partial_ref(
                    *a, window=w),
                lambda a=a, w=win: ref.decode_attention_partial_ref(
                    *f32(*a), window=w),
                lib, nbytes(q, k, v, qp, kp) + H * (hd + 2) * 4,
                4 * H * hd * S, "bf16" if dt == bf else "fp32"))
            # the combine's R partials are the plain partials of R ranks'
            # slots of one cache, q drawn at 3x so that a few keys carry
            # each row: the merged rows are O(1) (mean |out| ~0.2), well
            # above the bf16 atol
            n = R_ * S
            qc = rn(1, H, hd, dtype=dt) * 3.0
            kc, vc = rn(1, n, KV, hd, dtype=dt), rn(1, n, KV, hd, dtype=dt)
            kpc = (9000 - n + torch.arange(n, dtype=torch.int32,
                                           device=dev))[None]
            o, ml = (torch.stack(t) for t in zip(*(
                ref.decode_attention_partial_ref(
                    qc, kc[:, r * S:(r + 1) * S], vc[:, r * S:(r + 1) * S],
                    qp, kpc[:, r * S:(r + 1) * S]) for r in range(R_))))
            cases.append((
                "attention_combine", f"R={R_} B=1 H={H} hd={hd} {tag}",
                lambda o=o, ml=ml, dt=dt: ops.attention_combine(o, ml,
                                                                dtype=dt),
                lambda o=o, ml=ml, dt=dt: ref.attention_combine_ref(
                    o, ml, dtype=dt),
                lambda o=o, ml=ml: ref.attention_combine_ref(o, ml),
                None, nbytes(o, ml) + H * hd * (2 if dt == bf else 4),
                2 * R_ * H * (hd + 1), "fp32"))

    # RMSNorm at d 4096: a decode step's rows and a long prefill's, and a
    # decode step's at starcoder2-7b's, qwen2-moe's, seamless-m4t's and
    # llama-3.2-vision's widths; the fused add's library call is the add
    # then the norm
    for rows, d in ((8, 4096), (4096, 4096), (8, 4608), (8, 2048), (8, 1024),
                    (8, 8192)):
        x, y, w = rn(rows, d), rn(rows, d), rn(d) * 0.1
        w1 = 1.0 + w
        cases.append((
            "rmsnorm", f"rows={rows} d={d}",
            lambda x=x, w=w: ops.rmsnorm(x, w),
            lambda x=x, w=w: ref.rmsnorm_ref(x, w),
            lambda x=x, w=w: ref.rmsnorm_ref(x.float(), w.float()),
            lambda x=x, w1=w1, d=d: F.rms_norm(x, (d,), weight=w1,
                                               eps=1e-6),
            nbytes(x, w, x), 4 * rows * d, "bf16"))
        cases.append((
            "add_rmsnorm", f"rows={rows} d={d}",
            lambda x=x, y=y, w=w: ops.add_rmsnorm(x, y, w),
            lambda x=x, y=y, w=w: ref.add_rmsnorm_ref(x, y, w),
            lambda x=x, y=y, w=w: ref.add_rmsnorm_ref(*f32(x, y, w)),
            lambda x=x, y=y, w1=w1, d=d: F.rms_norm(x + y, (d,), weight=w1,
                                                    eps=1e-6),
            nbytes(x, y, w, x, x), 5 * rows * d, "bf16"))

    # the split form, a TP-2 rank's share of mamba2-2.7b's gated norm (2560
    # of d_inner 5120) at a decode step's rows and a 16-token chunk's, its
    # rows' sums taken as the whole's (the all-reduce is the group's; the
    # whole-row check is `run_split_rows`); its library call is F.rms_norm
    # over the whole rows, for reference
    for rows in SPLIT_ROWS:
        d, k = SPLIT_WIDTH
        x, w = rn(rows, d), rn(d) * 0.1
        xr, wr, w1 = x[:, :k].contiguous(), w[:k].contiguous(), 1.0 + w
        cases.append((
            "rmsnorm_split", f"rank rows={rows} d={k} of {d}",
            lambda xr=xr, wr=wr, d=d: ops.rmsnorm_split(xr, wr, d=d),
            lambda xr=xr, wr=wr, d=d: ref.rmsnorm_split_ref(xr, wr, d=d),
            lambda xr=xr, wr=wr, d=d: ref.rmsnorm_split_ref(
                xr.float(), wr.float(), d=d),
            lambda x=x, w1=w1, d=d: F.rms_norm(x, (d,), weight=w1, eps=1e-6),
            nbytes(xr, wr, xr), 4 * rows * k, "bf16"))

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


#: the sequence-sharded decode's kernel cases: (H, KV, hd, slots a rank,
#: ranks, window) of mistral-nemo-12b at data 16 and 2 and
#: recurrentgemma-9b at data 16
SEQ_CASES = ((32, 8, 128, 256, 16, 4096), (32, 8, 128, 2048, 2, 4096),
             (16, 1, 256, 128, 16, 2048))

#: launch-floor cases also timed as 100 launches in one CUDA graph
GRAPH_CASES = {("rmsnorm", "rows=8 d=4096"), ("add_rmsnorm", "rows=8 d=4096"),
               ("decode_attention_partial",
                "B=1 S=2048 H=32 KV=8 hd=128 bf16"),
               ("decode_attention_partial",
                "B=1 S=256 H=32 KV=8 hd=128 bf16"),
               ("decode_attention_partial",
                "B=1 S=128 H=16 KV=1 hd=256 bf16"),
               ("attention_combine", "R=2 B=1 H=32 hd=128 bf16"),
               ("attention_combine", "R=16 B=1 H=32 hd=128 bf16"),
               ("attention_combine", "R=16 B=1 H=16 hd=256 bf16"),
               ("decode_attention", "B=8 S=1024"),
               ("paged_decode_attention", "B=8 blocks=241"),
               ("flash_attention", "Tq=16 Tk=1024"),
               ("paged_flash_attention", "Tq=16 MB=64 bs=16"),
               ("flash_attention_wgmma", "encoder Tq=Tk=1024 hd=64 G=1"),
               ("flash_attention_wgmma", "Tq=500 Tk=1024"),
               ("rglru_gated_scan", "B=8 T=1 W=4096 bf16")}

#: the shapes at which both bf16 prefill kernels are timed on the same call
#: (the route's evidence): packed rows M = Tq * G of 64 (granite's Tq-16
#: chunk, kept on the mma.sync kernel), 128 (the VLM's Tq-16 cross chunk at
#: G 8), 1024 (seamless's encoder) and 2000 (granite's Tq 500 at G 4)
ROUTING_SHAPES = ("Tq=16 Tk=1024", "cross Tq=16 Tk=1601 G=8",
                  "encoder Tq=Tk=1024 hd=64 G=1", "Tq=500 Tk=1024")

#: the split form's cases: rows (a decode step's 8, a 16-token chunk's)
#: and (d_inner, a TP-2 rank's share) of mamba2-2.7b
SPLIT_ROWS = (8, 16)
SPLIT_WIDTH = (5120, 2560)

#: kernel -> (route, source, the TPU kernel it replaces, main-path case)
KERNELS = {
    "decode_attention": (
        "cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:83", "B=8 S=1024"),
    "paged_decode_attention": (
        "cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:139", "B=8 blocks=241"),
    "decode_attention_partial": (
        "cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:83",
        "B=1 S=2048 H=32 KV=8 hd=128 bf16"),
    "attention_combine": (
        "cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:83",
        "R=2 B=1 H=32 hd=128 bf16"),
    "flash_attention": (
        "cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:61", "Tq=16 Tk=1024"),
    "paged_flash_attention": (
        "cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:61", "Tq=16 MB=64 bs=16"),
    "flash_attention_wgmma": (
        "cuda", "src/repro_torch/kernels/csrc/flash_wgmma.cuh",
        "src/repro/kernels/flash_attention.py:61",
        "encoder Tq=Tk=1024 hd=64 G=1"),
    "paged_flash_attention_wgmma": (
        "cuda", "src/repro_torch/kernels/csrc/flash_wgmma.cuh",
        "src/repro/kernels/flash_attention.py:61", "Tq=500 MB=64 bs=16"),
    "rmsnorm": (
        "cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm.py:25", "rows=8 d=4096"),
    "add_rmsnorm": (
        "cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm.py:25", "rows=8 d=4096"),
    "rmsnorm_split": (
        "cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm.py:25", "rank rows=8 d=2560 of 5120"),
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
        bf16_in = name == "decode_attention_partial" and "bf16" in label
        err = max_err(got, want, bf16_in)
        if name == "add_rmsnorm" and not torch.equal(got[0], plain()[0]):
            raise AssertionError(f"add_rmsnorm {label}: the sum is not "
                                 f"bit for bit x + y")
        fp32 = (got[0] if isinstance(got, tuple) else got).dtype \
            == torch.float32 and not bf16_in
        b_ms, b_by = bound(n_bytes, n_ops, peak)
        r = dict(name=name, case=label, max_abs_err=err,
                 tol=f"{FP32_TOL} * max|plain|" if fp32
                 else f"{ATOL} + {RTOL} * |plain|",
                 ms=time_ms(kern, flush), plain_ms=time_ms(plain, flush),
                 library_ms=time_ms(lib, flush) if lib else None,
                 bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, ops=n_ops,
                 peak=f"{peak} {PEAK_FLOPS[peak] / 1e12} TFLOP/s")
        if "flash_attention" in name:
            r["kernel"] = "wgmma" if name.endswith("_wgmma") else "mma"
        if name.endswith("_wgmma"):  # the tensor maps are encoded a launch
            r["host_us"] = host_us(kern)
        if name in ("rmsnorm", "add_rmsnorm", "rmsnorm_split"):
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


def run_split_rows(dev) -> dict:
    """Kernel 4's split form over two simulated ranks (`kernels_split_rows`):
    whole rows of mamba2-2.7b's d_inner (SPLIT_WIDTH, SPLIT_ROWS rows) cut
    in two, each half normed by `ops.rmsnorm_split` with a reduce that adds
    the other half's fp32 sums of squares (the group's all-reduce), the
    halves put back together: within ATOL + RTOL · |want| of the rmsnorm
    kernel over the whole rows and of the fp32 plain norm. Beside it,
    printed, the same halves with the reduce dropped (each half normed by
    its own sums)."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(5)
    d, k = SPLIT_WIDTH
    out = {}
    for rows in SPLIT_ROWS:
        x = torch.randn((rows, d), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((d,), generator=g, device=dev) * 0.1).to(
            torch.bfloat16)
        halves = [x[:, :k].contiguous(), x[:, k:].contiguous()]
        sums = [(h.float() ** 2).sum(-1) for h in halves]
        got = torch.cat([ops.rmsnorm_split(
            h, w[r * k:(r + 1) * k].contiguous(), d=d,
            reduce=lambda s, r=r: s + sums[1 - r])
            for r, h in enumerate(halves)], -1)
        dropped = torch.cat([ops.rmsnorm_split(
            h, w[r * k:(r + 1) * k].contiguous(), d=d)
            for r, h in enumerate(halves)], -1)
        # max_err raises outside the tolerance
        out[f"rows={rows} d={d} halves of {k}"] = dict(
            vs_kernel=max_err(got, ops.rmsnorm(x, w)),
            vs_plain=max_err(got, ref.rmsnorm_ref(x.float(), w.float())),
            dropped_vs_kernel=float((dropped.float() - ops.rmsnorm(
                x, w).float()).abs().max()),
            tol=f"{ATOL} + {RTOL} * |want|")
    emit("kernels_split_rows", **out)
    return out


# ---------------------------------------------------------------------------
# phase 4: reference

#: arch -> (layers kept, prefill tokens, decode steps)
REFERENCE = {"granite-3-8b": (2, 64, 4), "mamba2-2.7b": (2, 300, 4),
             "recurrentgemma-9b": (3, 300, 4), "starcoder2-7b": (2, 64, 4),
             "mistral-nemo-12b": (2, 64, 4), "qwen1.5-32b": (1, 64, 4),
             "qwen2-moe-a2.7b": (2, 64, 4)}


#: a replayed MoE pick may fall short of the fp32 router's own k-th largest
#: probability by at most this share of it (a near tie): 3.3x the worst
#: shortfall measured on the card (0.0090), under half the median gap
#: (0.067) between the fp32 k-th and (k+1)-th probabilities, which a top-k
#: taking the wrong rank would fall short by (PERF.md §6)
NEAR_TIE = 0.03
#: and at most this share of the routed (token, k) picks may differ (7 of
#: 544 measured; a top-k off by one rank would differ on every token)
NEAR_TIE_PICKS = 0.03


class Routing:
    """The MoE router's picks (`layers.top_k`), taken from outside. The
    router's top-k is discontinuous: where two experts' probabilities
    nearly tie, bf16 rounding upstream may swap them, and the token then
    adds another expert's output. So the card's run records its picks and
    the CPU's fp32 run replays them (gates from its own probabilities at
    those experts): both add the same experts, and the logits compare the
    arithmetic. A replayed pick that is not among the fp32 router's own
    top-k must be a near tie (NEAR_TIE), and few (NEAR_TIE_PICKS); `gaps`
    holds each token's relative gap between its fp32 k-th and (k+1)-th
    probabilities, what a pick of the wrong rank would fall short by."""

    def __init__(self, layers):
        self.layers, self.top_k = layers, layers.top_k
        self.picks, self.replay = [], False
        self.routed, self.differ, self.shortfall = 0, 0, 0.0
        self.gaps = []

    def __enter__(self):
        self.layers.top_k = self
        return self

    def __exit__(self, *exc):
        self.layers.top_k = self.top_k

    def __call__(self, x, k):
        if not self.replay:
            v, i = self.top_k(x, k)
            self.picks.append(i.cpu())
            return v, i
        i = self.picks.pop(0).to(x.device)
        own, own_i = self.top_k(x, k + 1)
        kth, own_i = own[..., k - 1:k], own_i[..., :k]
        self.gaps.append(((kth - own[..., k:]) / kth).flatten())
        v = x.gather(-1, i)
        miss = ~(i[..., :, None] == own_i[..., None, :]).any(-1)
        self.routed += i.numel()
        if bool(miss.any()):
            short = ((kth - v).clamp_min(0) / kth)[miss]
            self.differ += int(miss.sum())
            self.shortfall = max(self.shortfall, float(short.max()))
        return v, i


# ---------------------------------------------------------------------------
# training


#: the six families' reduced configs trained on the card and the CPU
TRAIN_REDUCED = ("granite-3-8b", "qwen2-moe-a2.7b", "mamba2-2.7b",
                 "recurrentgemma-9b", "llama-3.2-vision-90b",
                 "seamless-m4t-medium")
#: full-width training runs: arch -> (layers kept or None for all, steps)
TRAIN_FULL = {"granite-3-8b": (16, 20), "mamba2-2.7b": (None, 10)}
#: bytes a parameter of training state: bf16 param and gradient, fp32
#: AdamW moments
TRAIN_STATE_BYTES = 12
#: the param trees stacked on a leading layer axis
TRAIN_STACKS = ("layers", "rec_layers", "att_layers", "cross_layers",
                "enc_layers", "dec_layers", "dec_cross")


def train_flops(cfg, n_params: int, B: int, T: int) -> float:
    """Model FLOPs of one training step, 3 x the forward's (the backward
    is twice the forward; remat's recomputation is not counted): 2 N a
    token for the N weights of the layers and the head (all parameters,
    the tied embedding once, as the head; an untied embedding's gather
    is not counted), plus 4 B T^2 H hd for each attention layer (the full
    square the plain attention computes) and, for each Mamba2 layer with
    chunks of Q, the SSD's products 2 B T Q (N + H P) + 4 B T N H P."""
    from repro_torch.config.base import ArchFamily
    from repro_torch.models.backbone import layer_counts
    from repro_torch.models.ssm import ssm_dims

    n = n_params - (0 if cfg.tie_embeddings
                    else cfg.vocab_size * cfg.d_model)
    fwd = 2.0 * n * B * T
    n_att, _ = layer_counts(cfg)
    fwd += 4.0 * B * T * T * cfg.num_heads * cfg.resolved_head_dim * n_att
    if cfg.family == ArchFamily.SSM:
        _, H, P, N = ssm_dims(cfg)
        Q = min(cfg.ssm.chunk_size, T)
        fwd += cfg.num_layers * (2.0 * B * T * Q * (N + H * P)
                                 + 4.0 * B * T * N * H * P)
    return 3.0 * fwd


def run_train_reduced(dev) -> dict:
    """Three train steps of each family's reduced config in fp32 on the
    card and on the CPU from the same params and batches: the losses agree
    within rtol 1e-4, and the card launches no kernel."""
    from repro_torch.config.base import TrainConfig
    from repro_torch.config.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.training.data import MarkovData
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import (make_train_step, to_device,
                                                 trainable)

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the fp32 products would not be "
                             "the CPU's")
    tcfg = TrainConfig(global_batch=2, seq_len=64, steps=3, lr=1e-3,
                       warmup_steps=1)
    out = {}
    before = dict(ops.LAUNCHES)
    for arch in TRAIN_REDUCED:
        cfg = get_config(arch, "reduced")
        p_cpu = build_model(cfg, torch.float32, "cpu").init(0)
        if "cross_layers" in p_cpu:
            p_cpu["cross_layers"]["attn"]["gate"].fill_(0.5)
        it = MarkovData(cfg, tcfg).batches()
        batches = [next(it) for _ in range(tcfg.steps)]
        losses = {}
        for d in ("cpu", dev):
            m = build_model(cfg, torch.float32, d)
            p = trainable(_copy_to(p_cpu, d))
            o, step = adamw_init(p), make_train_step(m, tcfg)
            losses[str(d)] = []
            for b in batches:
                p, o, met = step(p, o, to_device(b, d))
                losses[str(d)].append(float(met["loss"]))
        got, want = losses[str(dev)], losses["cpu"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        out[arch] = dict(card=got, cpu=want, rel_max_err=rel)
        if rel > 1e-4 or not all(math.isfinite(x) for x in got):
            raise AssertionError(f"train_reduced {arch}: card losses {got} "
                                 f"against the CPU's {want}")
    if ops.LAUNCHES != before:
        raise AssertionError(f"training launched a kernel: {before} -> "
                             f"{ops.LAUNCHES}")
    emit("train_reduced", tol=1e-4, steps=tcfg.steps,
         batch=tcfg.global_batch, seq=tcfg.seq_len, **out)
    return out


def _copy_to(t, dev):
    """A copy of a param tree on `dev` (the steps update params in
    place)."""
    return {k: _copy_to(v, dev) for k, v in t.items()} \
        if isinstance(t, dict) else t.to(dev, copy=True)


def run_train_full(dev, card: str, arch: str) -> dict:
    """`train_loop.train` at full width (depth cut by TRAIN_FULL) in bf16
    with fp32 moments: finite losses that fall, a finite non-zero
    gradient in every leaf at step 1, and the step's figures."""
    import dataclasses
    from repro_torch.config.base import TrainConfig
    from repro_torch.config.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.params import named_leaves
    from repro_torch.training.data import MarkovData
    from repro_torch.training.train_loop import (to_device, train,
                                                 trainable, value_and_grad)

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on")
    layers, steps = TRAIN_FULL[arch]
    whole = get_config(arch, "full")
    cfg = dataclasses.replace(whole, num_layers=layers) if layers else whole
    tcfg = TrainConfig(steps=steps, lr=3e-4, warmup_steps=2)
    model = build_model(cfg, torch.bfloat16, dev)
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    params = trainable(model.init(tcfg.seed))
    n_params = sum(x.numel() for _, x in named_leaves(params))
    # step 1's gradient: train() draws the same first batch from a fresh
    # MarkovData of the same seed
    batch = to_device(next(MarkovData(cfg, tcfg).batches()), dev)
    loss1, _, grads = value_and_grad(model, params, batch, tcfg.remat)
    norms = {}
    for name, g in named_leaves(grads):
        # a stacked leaf layer by layer: a branch cut in one layer shows
        stacked = name.split("/")[0] in TRAIN_STACKS
        for i, sl in enumerate(g.unbind(0) if stacked else (g,)):
            norms[f"{name}[{i}]" if stacked else name] = float(
                sl.float().norm())
    del grads, batch
    bad = {k: v for k, v in norms.items()
           if not math.isfinite(v) or v == 0.0}
    if bad or not math.isfinite(float(loss1)):
        raise AssertionError(f"train_{arch}: step 1's gradient is zero or "
                             f"not finite in {bad} (loss {float(loss1)})")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    after_init = torch.cuda.memory_allocated()
    res = train(model, tcfg, log=None, params=params)
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    k = 5
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    step_s = statistics.median(res["step_ms"]) / 1e3
    tokens = tcfg.global_batch * tcfg.seq_len
    flops = train_flops(cfg, n_params, tcfg.global_batch, tcfg.seq_len)
    fields = dict(
        arch=arch, card=card, layers=cfg.num_layers,
        of_layers=whole.num_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, params=n_params,
        state_gb=n_params * TRAIN_STATE_BYTES / 1e9,
        whole_state_gb=whole.param_count() * TRAIN_STATE_BYTES / 1e9,
        cut=(f"{cfg.num_layers} of {whole.num_layers} layers: the whole "
             f"model's params, grads and AdamW state need "
             f"{whole.param_count() * TRAIN_STATE_BYTES / 1e9:.1f} GB, "
             f"more than the card's 80 GB") if layers else None,
        dtype="bfloat16", moments="float32", remat=tcfg.remat,
        batch=tcfg.global_batch, seq=tcfg.seq_len, steps=steps,
        lr=tcfg.lr, warmup=tcfg.warmup_steps, losses=losses,
        first5_mean=first, last5_mean=last, step1_loss=float(loss1),
        grad_slices=len(norms), grad_norm_min=min(norms.values()),
        grad_norm_min_slice=min(norms, key=norms.get),
        step_ms=res["step_ms"], step_ms_median=step_s * 1e3,
        tokens_per_s=tokens / step_s, wall_tokens_per_s=res["tokens_per_s"],
        peak_memory_gb=peak / 1e9, peak_memory_bytes=peak,
        allocated_after_init_bytes=after_init,
        moment_bytes=8 * n_params, flops_per_step=flops,
        flops_formula="3 x (2 N B T + 4 B T^2 H hd L_att + L_ssm (2 B T Q "
                      "(N_state + H P) + 4 B T N_state H P))",
        model_tflops=flops / step_s / 1e12,
        share_of_bf16_peak=flops / step_s / PEAK_FLOPS["bf16"],
        seconds=time.perf_counter() - t0)
    emit(f"train_{arch}", **fields)
    if not all(math.isfinite(x) for x in losses) or not last < first:
        raise AssertionError(f"train_{arch}: the losses do not fall: "
                             f"{losses}")
    if ops.LAUNCHES != before:
        raise AssertionError(f"train_{arch}: training launched a kernel")
    del res, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return fields


#: the dry run's training shape: the train phase's batch and length
DRY_SHAPE = dict(name="train_smoke", seq_len=256, global_batch=8,
                 kind="train")
#: meshes of the whole granite-3-8b's fit rows: one card, two as a model
#: axis, two as a data axis (FSDP), one NVLink node of 8
FIT_MESHES = ({"data": 1, "model": 1}, {"data": 1, "model": 2},
              {"data": 2, "model": 1}, {"data": 1, "model": 8})
#: the predicted peak against the measured one, and the part above the
#: params and moments
DRY_PEAK_TOL, DRY_TEMP_TOL = 0.05, 0.25
#: the layers of the one-rank NCCL training step
DRY_RANK_LAYERS = 4


def run_dryrun(dev, card: str, train_runs: dict) -> dict:
    """The dryrun phase: (a) the train phase's peaks predicted on the meta
    device, (b) the whole granite-3-8b's fit rows, (c) a one-rank NCCL
    training step bit for bit with no group. The rows of (a) and (b) run
    in spawned processes (the meta device, no card), all at once and
    beside (c) on the card."""
    import concurrent.futures
    import dataclasses
    import multiprocessing
    from repro_torch.config.base import InputShape
    from repro_torch.config.registry import get_config
    from repro_torch.launch.dryrun import run_one

    t0 = time.perf_counter()
    shape = InputShape(**DRY_SHAPE)
    granite = get_config("granite-3-8b", "full")
    out, bad = {"predicted": {}, "fit": []}, []
    with concurrent.futures.ProcessPoolExecutor(
            len(TRAIN_FULL) + len(FIT_MESHES),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        predicted = {}
        for arch, (layers, _) in TRAIN_FULL.items():
            whole = get_config(arch, "full")
            cfg = dataclasses.replace(whole, num_layers=layers) if layers \
                else whole
            predicted[arch] = pool.submit(run_one, cfg, shape,
                                          {"data": 1, "model": 1},
                                          arch=arch)
        fit = [pool.submit(run_one, granite, shape, mesh,
                           arch="granite-3-8b") for mesh in FIT_MESHES]
        out["one_rank"] = _dry_one_rank(dev)
        predicted = {arch: f.result() for arch, f in predicted.items()}
        fit = [f.result() for f in fit]
    for arch, row in predicted.items():
        if row["status"] != "ok":
            emit("dryrun_predicted", arch=arch, **row)
            bad.append(arch)
            continue
        run = train_runs[arch]
        state = run["allocated_after_init_bytes"] + run["moment_bytes"]
        measured_above = run["peak_memory_bytes"] - state
        peak_err = row["peak_bytes"] / run["peak_memory_bytes"] - 1
        temp_err = row["temp_size_in_bytes"] / measured_above - 1
        out["predicted"][arch] = dict(
            card=card, layers=run["layers"], status=row["status"],
            predicted_peak_bytes=row["peak_bytes"],
            measured_peak_bytes=run["peak_memory_bytes"],
            peak_rel_err=peak_err,
            predicted_arguments_bytes=row["argument_size_in_bytes"],
            measured_state_bytes=state,
            predicted_above_state_bytes=row["temp_size_in_bytes"],
            measured_above_state_bytes=measured_above,
            above_state_rel_err=temp_err, arguments=row["arguments"],
            flops=row["flops"], meta_s=row["meta_s"])
        emit("dryrun_predicted", arch=arch, **out["predicted"][arch])
        if abs(peak_err) > DRY_PEAK_TOL or abs(temp_err) > DRY_TEMP_TOL:
            bad.append(arch)
    keep = ("mesh", "status", "reason", "argument_size_in_bytes",
            "gathered_bytes", "temp_size_in_bytes", "peak_bytes", "fits",
            "capacity_bytes", "capacity_of", "flops", "collectives",
            "serve_weight_bytes", "meta_s")
    for row in fit:
        out["fit"].append({k: row[k] for k in keep if k in row})
        emit("dryrun_fit", arch="granite-3-8b", card=card,
             batch=shape.global_batch, seq=shape.seq_len,
             peak_gb=row["peak_bytes"] / 1e9, **out["fit"][-1])
        if row["status"] != "ok":
            bad.append(row["mesh"])
    out["seconds"] = time.perf_counter() - t0
    if bad or not out["one_rank"]["bit_for_bit"]:
        raise AssertionError(f"dryrun: the predicted peaks are off or a "
                             f"row failed {bad}, or the one-rank step "
                             f"departs: {out['one_rank']}")
    return out


def _dry_one_rank(dev) -> dict:
    """(c): granite-3-8b at full width on DRY_RANK_LAYERS layers, one
    training step's loss and gradients on a (1, 1) NCCL group against
    the no-group step's, the group's collectives traced."""
    import dataclasses
    import tempfile
    from repro_torch.analysis.graph_audit import ALLREDUCE, GATHER, OpTrace
    from repro_torch.config.base import TrainConfig
    from repro_torch.config.registry import get_config
    from repro_torch.launch.mesh import close_serving_group, make_serving_group
    from repro_torch.models.model import build_model
    from repro_torch.params import named_leaves
    from repro_torch.training.data import MarkovData
    from repro_torch.training.train_loop import (to_device, trainable,
                                                 value_and_grad)

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("granite-3-8b", "full"),
                              num_layers=DRY_RANK_LAYERS)
    tcfg = TrainConfig()
    batch = to_device(next(MarkovData(cfg, tcfg).batches()), dev)
    whole = build_model(cfg, torch.bfloat16, dev).init(0)
    loss1, _, g1 = value_and_grad(build_model(cfg, torch.bfloat16, dev),
                                  trainable(whole), batch)
    with tempfile.TemporaryDirectory() as d:
        group = make_serving_group((1, 1), "nccl", 0, 1,
                                   init_method=f"file://{d}/store")
        try:
            model = build_model(cfg, torch.bfloat16, dev, group=group)
            with OpTrace() as tr:
                loss, _, g = value_and_grad(model,
                                            trainable(model.shard(whole)),
                                            batch)
            torch.cuda.synchronize()
        finally:
            close_serving_group()
    want = dict(named_leaves(g1))
    differ = [n for n, x in named_leaves(g) if not torch.equal(x, want[n])]
    res = dict(layers=cfg.num_layers, loss=float(loss),
               no_group_loss=float(loss1),
               loss_equal=bool(torch.equal(loss, loss1)),
               leaves=len(want), leaves_differ=differ,
               bit_for_bit=bool(torch.equal(loss, loss1)) and not differ,
               allreduces=tr.collectives.get(ALLREDUCE, 0),
               gathers=tr.collectives.get(GATHER, 0),
               seconds=time.perf_counter() - t0)
    emit("dryrun_one_rank", **res)
    if not res["allreduces"]:
        raise AssertionError("dryrun (c): the group's step traced no "
                             "all-reduce")
    del g, g1, whole, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return res


def to_cpu(t):
    """A param tree on the CPU in fp32."""
    return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) \
        else t.float().cpu()


def run_reference(dev, arch: str):
    """Full width, depth cut to one layer pattern: the kernels' path (bf16,
    card) against the plain path (fp32, CPU) with the same weights; a MoE
    arch's fp32 run takes the card's expert picks (`Routing`)."""
    import dataclasses
    from repro_torch.config.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model

    layers, T, n_dec = REFERENCE[arch]
    cfg = dataclasses.replace(get_config(arch, "full"), num_layers=layers)
    m = build_model(cfg, torch.bfloat16, dev)
    params = m.init(0)
    m_cpu = build_model(cfg, torch.float32, "cpu")
    p_cpu = to_cpu(params)
    toks = torch.randint(0, cfg.vocab_size, (1, T + n_dec),
                         generator=torch.Generator().manual_seed(0))
    pos = torch.arange(T + n_dec, dtype=torch.int32)[None]
    outs = []
    ops.reset_launches()
    with Routing(L) as routing:
        for model, p, d in ((m, params, dev), (m_cpu, p_cpu, "cpu")):
            cache = model.init_cache(1, 2 * T, prefill_chunk=T)
            lg, cache = model.prefill(p, toks[:, :T].to(d),
                                      pos[:, :T].to(d), cache, last_only=True)
            seq = [lg[0, -1]]
            for t in range(T, T + n_dec):
                lg, cache = model.decode_step(p, toks[:, t].to(d),
                                              pos[:, t].to(d), cache)
                seq.append(lg[0])
            outs.append(torch.stack(seq).float().cpu())
            routing.replay = True
    got, want = outs
    moe = {}
    if cfg.moe is not None:
        gaps = torch.cat(routing.gaps)
        moe = dict(routed_calls=layers * (1 + n_dec),
                   routed_picks=routing.routed,
                   picks_replayed_differing=routing.differ,
                   max_shortfall=routing.shortfall, near_tie=NEAR_TIE,
                   near_tie_picks=NEAR_TIE_PICKS,
                   kth_gap_median=float(gaps.median()),
                   kth_gap_below_near_tie=float(
                       (gaps < NEAR_TIE).float().mean()))
        if routing.picks or routing.shortfall > NEAR_TIE \
                or routing.differ > NEAR_TIE_PICKS * routing.routed:
            raise AssertionError(f"{arch}: the card's expert picks are not "
                                 f"the fp32 router's up to near ties: {moe}")
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
         argmax_agreement=same, launches=launches, **moe)
    if rel > 5e-2:
        raise AssertionError(f"{arch}: kernel path vs fp32 plain path: "
                             f"rel err {rel}")
    del m, params, m_cpu, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=arch, rel_max_err=rel, argmax_agreement=same)


#: the cross families' reference: arch -> (depth cut, prompt tokens,
#: decode steps); the prompt is prefilled in chunks of 16, the extras
#: (at the stub frontend's real length) on the first
CROSS_REFERENCE = {
    "seamless-m4t-medium": (dict(num_layers=2, encoder_layers=2), 64, 4),
    "llama-3.2-vision-90b": (dict(num_layers=4, num_cross_layers=1), 64, 4)}


def set_gates(params, value: float = 0.5) -> None:
    """Every cross layer's tanh gate at `value`, in place: at its initial
    zero the VLM's cross-attention adds nothing (enc-dec has no gate in
    its forward; its gates are set all the same)."""
    for key in ("cross_layers", "dec_cross"):
        if key in params:
            params[key]["attn"]["gate"].fill_(value)


def run_cross_reference(dev, arch: str):
    """The VLM / enc-dec families at full width, depth cut to one pattern
    (CROSS_REFERENCE), every gate at 0.5: a first chunk with extras (1601
    image patches, or 1024 audio frames through the encoder), three more
    chunks, then decode steps. The kernels' path on the card in bf16,
    contiguous and paged (the cross K/V read in place through the
    request's slot), against the plain path on the CPU in fp32, the same
    weights and extras: each chunk's last logits and each step's within
    5e-2 of max|logit|. Each forward launches its norms as the serve
    phase counts them; only the encoder launches contiguous attention in
    a paged run."""
    import dataclasses
    from repro_torch.config.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.backbone import extras_key, n_cross_layers
    from repro_torch.models.model import build_model, default_enc_len

    cut, T, n_dec = CROSS_REFERENCE[arch]
    cfg = dataclasses.replace(get_config(arch, "full"), **cut)
    enc_len, chunk, bs = default_enc_len(cfg), 16, 16
    n = T + n_dec
    m = build_model(cfg, torch.bfloat16, dev)
    params = m.init(0)
    set_gates(params)
    m_cpu = build_model(cfg, torch.float32, "cpu")
    p_cpu = to_cpu(params)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, n), generator=g)
    pos = torch.arange(n, dtype=torch.int32)[None]
    extras = torch.randn((1, enc_len, cfg.d_model), generator=g)
    key = extras_key(cfg)
    nb = -(-n // bs)

    def serve(model, p, d, paged):
        tb = torch.arange(nb, dtype=torch.int32, device=d)[None]
        rows = torch.zeros(1, dtype=torch.int64, device=d)
        cache = model.init_paged_cache(nb, bs, n_slots=1, enc_len=enc_len) \
            if paged else model.init_cache(1, n, enc_len=enc_len,
                                           prefill_chunk=chunk)
        ops.reset_launches()
        seq = []
        for s_ in range(0, T, chunk):
            t_, p_ = toks[:, s_:s_ + chunk].to(d), pos[:, s_:s_ + chunk].to(d)
            ex = {key: extras.to(d)} if s_ == 0 else None
            lg, cache = model.prefill_paged(p, t_, p_, tb, cache, rows=rows,
                                            extras=ex, last_only=True) \
                if paged else model.prefill(p, t_, p_, cache, extras=ex,
                                            last_only=True)
            seq.append(lg[0, -1])
        for t in range(T, n):
            t_, p_ = toks[:, t].to(d), pos[:, t].to(d)
            lg, cache = model.decode_step_paged(p, t_, p_, tb, cache,
                                                rows=rows) \
                if paged else model.decode_step(p, t_, p_, cache)
            seq.append(lg[0])
        return (torch.stack(seq).float().cpu(),
                {k: v for k, v in ops.LAUNCHES.items() if v})

    want, _ = serve(m_cpu, p_cpu, "cpu", False)
    forwards = T // chunk + n_dec
    enc = cfg.encoder_layers
    norms = (forwards + (1 if enc else 0),
             2 * (cfg.num_layers + n_cross_layers(cfg)) * forwards
             + (2 * enc - 1 if enc else 0))
    out = dict(arch=arch, layers=cut, d_model=cfg.d_model, enc_len=enc_len,
               prompt_tokens=T, chunk=chunk, decode_steps=n_dec, gate=0.5,
               tol=5e-2, norms_expected=norms)
    for paged in (False, True):
        got, launches = serve(m, params, dev, paged)
        rel = float((got - want).abs().max() / want.abs().max())
        out["paged" if paged else "contiguous"] = dict(
            rel_max_err=rel, launches=launches,
            argmax_agreement=float((got.argmax(-1) == want.argmax(-1))
                                   .float().mean()))
        other = {k: launches.get(k, 0) for k in ATTENTION[not paged]}
        if paged:
            other["flash_attention"] -= enc   # the encoder's, once
        if rel > 5e-2 or not bool(torch.isfinite(got).all()) \
                or any(launches.get(k, 0) == 0 for k in ATTENTION[paged]) \
                or any(other.values()) or (launches.get("rmsnorm"),
                                           launches.get("add_rmsnorm")) \
                != norms:
            emit("cross_reference", **out)
            raise AssertionError(f"cross reference {arch}: {out}")
    emit("cross_reference", **out)
    del m, params, m_cpu, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_sliding_reference(dev):
    """mistral-nemo-12b's sliding variant (SLIDING's window) at full width,
    2 layers: 1040 prompt tokens prefilled in chunks of 16 (the contiguous
    ring of window + 15 slots wraps), then 4 decode steps past position
    1040. The kernels' path on the card in bf16, contiguous ring and paged
    (the window mask over a block table of every token), against the plain
    path on the CPU in fp32 on the ring, the same weights: each chunk's
    last logits and each step's within 5e-2 of max|logit|."""
    import dataclasses
    from repro_torch.configs.mistral_nemo_12b import sliding
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    _, window = SLIDING
    cfg = dataclasses.replace(sliding(window=window), num_layers=2)
    T, chunk, n_dec, bs = 1040, 16, 4, 16
    n = T + n_dec
    m = build_model(cfg, torch.bfloat16, dev)
    params = m.init(0)
    m_cpu = build_model(cfg, torch.float32, "cpu")
    p_cpu = to_cpu(params)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, n), generator=g)
    pos = torch.arange(n, dtype=torch.int32)[None]
    tables = torch.randperm(-(-n // bs), generator=g).to(torch.int32)[None]

    def serve(model, p, d, paged):
        """(the logits, the kernels launched, the K/V slots a cache row
        holds: the ring's when contiguous)."""
        tb = tables.to(d)
        cache = model.init_paged_cache(tables.shape[1], bs) if paged \
            else model.init_cache(1, n, prefill_chunk=chunk)
        ops.reset_launches()
        seq = []
        for s_ in range(0, T, chunk):
            t_, p_ = toks[:, s_:s_ + chunk].to(d), pos[:, s_:s_ + chunk].to(d)
            lg, cache = model.prefill_paged(p, t_, p_, tb, cache,
                                            last_only=True) if paged \
                else model.prefill(p, t_, p_, cache, last_only=True)
            seq.append(lg[0, -1])
        for t in range(T, n):
            t_, p_ = toks[:, t].to(d), pos[:, t].to(d)
            lg, cache = model.decode_step_paged(p, t_, p_, tb, cache) \
                if paged else model.decode_step(p, t_, p_, cache)
            seq.append(lg[0])
        return (torch.stack(seq).float().cpu(),
                {k: v for k, v in ops.LAUNCHES.items() if v},
                cache["k"].shape[2])

    want, _, ring_slots = serve(m_cpu, p_cpu, "cpu", False)
    out = dict(window=window, layers=2, prompt_tokens=T, chunk=chunk,
               decode_steps=n_dec, ring_slots=ring_slots, tol=5e-2)
    if ring_slots != window + chunk - 1 or ring_slots >= T:
        raise AssertionError(f"sliding reference: a ring of {ring_slots} "
                             f"slots for {T} tokens")
    for paged in (False, True):
        got, launches, _ = serve(m, params, dev, paged)
        rel = float((got - want).abs().max() / want.abs().max())
        out["paged" if paged else "contiguous"] = dict(
            rel_max_err=rel, launches=launches,
            argmax_agreement=float((got.argmax(-1) == want.argmax(-1))
                                   .float().mean()))
        if rel > 5e-2 or not bool(torch.isfinite(got).all()) \
                or any(launches.get(k, 0) == 0 for k in ATTENTION[paged]) \
                or any(launches.get(k, 0) for k in ATTENTION[not paged]):
            raise AssertionError(f"sliding reference {out}")
    emit("sliding_reference", **out)
    del m, params, m_cpu, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5: serving


def serve_prompts(arch: str):
    from repro_torch.bench.kv_swap import prompts
    from repro_torch.config.registry import get_config

    return prompts(get_config(arch, "full").vocab_size, FAMILIES[arch][0],
                   PROMPT_LO, PROMPT_HI)


def run_serve(arch: str, paged: bool, depth: int = 0,
              beside: Optional[dict] = None, cfg=None, dtype=None, mesh=()):
    """Serve the family's prompts through `launch.serve.build_engine` (its
    graphs captured by `warmup` first), `depth` intervals dispatched ahead
    (DESIGN §14), and check the run. `beside`: the depth-0 run's figures,
    printed on the line. `cfg`: a variant of the arch's full config (the
    run is named after it). `dtype`:
    the weights' type, if not bf16. `mesh`: serve on that mesh, on the
    ambient serving group this process joined. Returns (the emitted
    fields, the engine, the requests)."""
    import dataclasses

    import numpy as np
    from repro_torch.config.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import default_enc_len
    from repro_torch.serving.graphs import WARMUP_RUNS

    n_req, path, attends, (fused, plain), per_forward = FAMILIES[arch]
    if mesh and arch in MESH_NORMS:
        (fused, plain), more = MESH_NORMS[arch]
        path, per_forward = path + tuple(more), dict(per_forward, **more)
    args = serve.build_parser().parse_args(
        serve_args(arch) + (["--paged"] if paged else [])
        + ["--overlap-depth", str(depth)]
        + (["--mesh", ",".join(map(str, mesh))] if mesh else []))
    if cfg is None and arch in DEPTH_CUTS:
        cfg = dataclasses.replace(get_config(arch, "full"),
                                  **DEPTH_CUTS[arch])
    t0 = time.perf_counter()
    eng = serve.build_engine(
        args, cfg=cfg, dtype=dtype,
        enc_len=default_enc_len(cfg or get_config(arch, "full")))
    set_gates(eng.params)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm = eng.graphs.stats()
    warm_keys = set(eng.graphs.steps)
    # the extras (1, enc_len, d) of each request, drawn before the clock
    mk_extras = serve.extras_drawer(eng, np.random.RandomState(1))
    reqs = [(p, mk_extras()) for p in serve_prompts(arch)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    handles = [eng.submit(p, extras=x) for p, x in reqs]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.summary()
    raw = dict(ops.LAUNCHES)
    # every admission prefills from position 0, so its first chunk (with
    # extras) runs once, and a first-chunk shape captured at first use
    # runs WARMUP_RUNS more times eagerly: the launches of a forward are
    # what remains
    captured = sum(1 for k in eng.graphs.steps if k[0] == "xchunk"
                   and k not in warm_keys) if eng.graphs.enabled else 0
    first_chunks = s["admitted"] + WARMUP_RUNS * captured \
        if arch in FIRST_CHUNK else 0
    launches = {k: n - FIRST_CHUNK.get(arch, {}).get(k, 0) * first_chunks
                for k, n in raw.items()}
    allocator_full = eng.blocks.free_blocks == eng.blocks.num_blocks
    name = f"serve_{cfg.name if cfg else arch}_" \
        f"{'paged' if paged else 'contiguous'}" \
        + (f"_overlap{depth}" if depth else "") \
        + ("_fp32" if dtype == torch.float32 else "") \
        + ("_mesh" + "x".join(map(str, mesh)) if mesh else "")
    n_int = len(eng.step_host_trace)
    caught = eng.graphs.capture_s - warm["capture_s"]
    fields = dict(summary=s, launches=raw, build_s=build_s,
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
                  max_context=eng.max_context, enc_len=eng.enc_len,
                  layers=eng.cfg.num_layers,
                  cross_layers=eng.cfg.num_cross_layers,
                  first_chunks=first_chunks,
                  forward_launches=launches if first_chunks else None)
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
    if not eng.graphs.enabled or any(
            st.graph is None for st in eng.graphs.steps.values()):
        raise AssertionError(f"{name}: a step ran without its graph")
    if eng.overlap_depth != depth or eng._inflight:
        raise AssertionError(f"{name}: depth {eng.overlap_depth}, "
                             f"{len(eng._inflight)} intervals left in flight")
    return fields, eng, handles


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
    from repro_torch.bench.kv_swap import request_sets
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
            serve_args(arch) + (["--paged"] if layout == "paged" else [])
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


# ---------------------------------------------------------------------------
# tensor-parallel serving (DESIGN §12) on the one card

#: the archs served tensor-parallel: the dense family's, then one arch of
#: each other family (the MoE's, the enc-dec's, the VLM's at its
#: DEPTH_CUTS, the SSM's and the hybrid's), and the mesh of tp (b): two
#: gloo ranks on the one card (NCCL refuses two ranks on one device)
TP_ARCH = "granite-3-8b"
TP_MORE = ("qwen2-moe-a2.7b", "seamless-m4t-medium", "llama-3.2-vision-90b",
           "mamba2-2.7b", "recurrentgemma-9b")
#: kernels only a mesh's forward launches (the split form of the norm:
#: mamba2's gated norm over a rank's d_inner / m), checked after the tp
#: runs; and the norm launches a forward where a mesh changes them:
#: arch -> ((fused, plain), other kernels a forward)
TP_PATH = ("rmsnorm_split", "decode_attention_partial", "attention_combine")
MESH_NORMS = {"mamba2-2.7b": ((64, 1), {"rmsnorm_split": 64})}
TP_GLOO_MESH = (1, 2)
#: tp (b)'s flags beside SERVE_ARGS, and its prompts (count, lengths): its
#: steps run eagerly and each all-reduce goes through the host, so the
#: static policy and short prompts keep its intervals few
TP_GLOO_ARGS = ["--policy", "static", "--max-new", "16"]
TP_GLOO_PROMPTS = (4, 32, 96)
#: tp (b)'s layouts (paged?) per arch: both for the dense family and the
#: MoE; the paged one for the cross families, whose contiguous layout the
#: CPU tests hold (tests/test_torch_tp_serving.py)
TP_GLOO_LAYOUTS = {TP_ARCH: (False, True), "qwen2-moe-a2.7b": (False, True),
                   "seamless-m4t-medium": (True,),
                   "llama-3.2-vision-90b": (True,), "mamba2-2.7b": (True,),
                   "recurrentgemma-9b": (True,)}
#: tp (b)'s logit rule. At full depth and random weights bf16 is chaotic:
#: the single device differs from itself by about as much as from the two
#: ranks when only its launch shapes change, so the rule is held at a cut
#: depth, at full width: the TP-2 model's first decode step (and the
#: prefill's last logits) against the single-device bf16 step on the same
#: inputs, max|diff| within TP_LOGIT_TOL of max|logit|; the same model with
#: one all-reduce dropped (a planted fault: granite's last MLP, qwen2-moe's
#: last layer's experts, the cross families' last cross layer's `wo`) must
#: exceed it. On the H100 granite's sound readings were at most 0.0159 (a
#: few bf16 steps of the largest logit) and the fault's at least 0.321
#: (PERF.md §6): the limit sits at about twice the one, under a tenth of
#: the other. A MoE's TP run replays the single device's expert picks
#: (`Routing`; bf16 partial sums can flip a near tie), and the picks that
#: differed before the replay are counted.
TP_PROBE_LAYERS = 4
TP_LOGIT_TOL = 3e-2
#: each arch's cut for the rule: TP_PROBE_LAYERS decoder layers (the
#: enc-dec's encoder too; the VLM's one cross layer after them)
TP_PROBE_CUTS = {TP_ARCH: dict(num_layers=TP_PROBE_LAYERS),
                 "starcoder2-7b": dict(num_layers=TP_PROBE_LAYERS),
                 "qwen2-moe-a2.7b": dict(num_layers=TP_PROBE_LAYERS),
                 "seamless-m4t-medium": dict(num_layers=TP_PROBE_LAYERS,
                                             encoder_layers=TP_PROBE_LAYERS),
                 "llama-3.2-vision-90b": dict(num_layers=TP_PROBE_LAYERS,
                                              num_cross_layers=1),
                 "mamba2-2.7b": dict(num_layers=TP_PROBE_LAYERS),
                 # (r, r, a, r): three recurrent layers and one attention
                 "recurrentgemma-9b": dict(num_layers=TP_PROBE_LAYERS)}
#: cross keys a request of the cross families' held probe. A cross read
#: over the real 1024-1601 random keys averages them to ~1/40 of a value
#: row, so its `wo` all-reduce moves a logit by ~1-2% (a CPU estimate at
#: d 1024-2048), under the rule's resolution; over 16 keys (the CLI's
#: length) it moves it 5-11%. The rule is held there; the real length's
#: readings, its fault's too, are printed beside it.
TP_PROBE_ENC_LEN = 16


def tp_config(arch: str):
    """`arch`'s full config, at DEPTH_CUTS where it has one."""
    import dataclasses

    from repro_torch.config.registry import get_config

    return dataclasses.replace(get_config(arch, "full"),
                               **DEPTH_CUTS.get(arch, {}))


def count_collectives(fn, *args):
    """((the all-reduces, the gathers) `fn(*args)` dispatched, traced by
    the graph audit's `OpTrace`; its result)."""
    from repro_torch.analysis.graph_audit import ALLREDUCE, GATHER, OpTrace

    with torch.no_grad(), OpTrace() as tr:
        out = fn(*args)
    return (tr.collectives.get(ALLREDUCE, 0),
            tr.collectives.get(GATHER, 0)), out


def run_tp_kernels(dev):
    """tp (c): kernels 1-3, 5 and 6 per rank at the TP-2 shapes
    (`repro_torch.bench.tp_slices`: granite-3-8b's decode, paged decode and
    chunks, each rank's 16 query heads on its 4 kv-heads; the non-causal
    launches of seamless-m4t's encoder, 8 of 16 heads at Tq = Tk = 1024,
    and of the VLM's decode-step cross read, 32 heads on 4 kv-heads over
    1601 patches, contiguous and paged; recurrentgemma-9b's 8 of 16 heads
    on its kv-head of 256 gathered whole, decode B 8 over its 2048 window,
    contiguous and paged, and Tq 16 chunks; mamba2-2.7b's SSD term on 40
    of 80 heads; the gated RG-LRU on 2048 of 4096 channels, B 8 T 1 and B
    2 T 16), compared with the same heads or channels of the whole launch,
    in bf16 and fp32: an attention launch on the rank's kv-heads bit for
    bit in fp32 and where both launches split the key axis alike, every
    other case within 2e-2 (bf16) or 1e-4 of max|whole| (fp32). Rank 0's
    serving shapes (decode B 8 over rows of 33-1024 slots, the Tq 16
    chunks, the non-causal cases, the hybrid's attention, the SSD and
    RG-LRU cases) are timed like the kernels phase's rows (with their
    plain versions, SDPA where one call computes the same function, and
    bounds at the rank's bytes and operations). Returns (the slice
    checks, the timed rows)."""
    import torch.nn.functional as F
    from repro_torch.bench import tp_slices
    from repro_torch.kernels import ref

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    plains = {"decode_attention": ref.decode_attention_ref,
              "paged_decode_attention": ref.paged_decode_attention_ref,
              "flash_attention": ref.flash_attention_ref,
              "paged_flash_attention": ref.paged_flash_attention_ref,
              "ssd_intra": ref.ssd_intra_ref,
              "rglru_gated_scan": ref.rglru_gated_scan_ref}
    timed_cases = ("B=8 fill=33-1024", "Tq=16")

    def timed(case, dtype):
        """Rank 0's serving shapes: granite's, the non-causal launches,
        the hybrid's attention and RG-LRU in bf16, the SSD term (fp32)."""
        if case.name == "ssd_intra":
            return True
        return dtype == torch.bfloat16 and (
            not case.causal or case.label in timed_cases
            or case.label.startswith("hybrid")
            or case.name == "rglru_gated_scan")

    def sdpa(case, a):
        if case.name == "decode_attention":
            q, k, v, qp, kp = a
            m = ((kp >= 0) & (kp <= qp[:, None]))[:, None, None, :]
            return lambda: F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=m, enable_gqa=True)
        if case.name == "flash_attention":
            q, k, v, qp, kp = a
            m = None if not case.causal else \
                ((kp[:, None, :] >= 0)
                 & (kp[:, None, :] <= qp[:, :, None]))[:, None]
            return lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=m, enable_gqa=True)
        return None

    checks, rows = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for case in tp_slices.cases(dev, dtype):
            c = tp_slices.compare(case)
            c["ok"] = tp_slices.verdict(c)
            checks.append(c)
            if not timed(case, dtype):
                continue
            a = case.rank_args(0)
            kw = {} if case.causal else {"causal": False}
            if case.label.startswith("hybrid"):
                kw["window"] = tp_slices.HYBRID[3]
            got = case.fn(*a)
            want = plains[case.name](*[t.float() if t.is_floating_point()
                                       else t for t in a], **kw)
            lib = sdpa(case, a)
            b_ms, b_by = bound(case.rank_bytes(), case.rank_ops(), case.peak)
            name = case.name + ("_wgmma" if case.kernel(tp_slices.M)
                                 == "wgmma" else "")
            r = dict(name=name, case=f"TP-2 rank 0: {case.label}",
                     max_abs_err=max_err(got, want),
                     tol=f"{ATOL} + {RTOL} * |plain|",
                     ms=time_ms(lambda: case.fn(*a), flush),
                     plain_ms=time_ms(lambda: plains[case.name](*a, **kw),
                                      flush),
                     library_ms=time_ms(lib, flush) if lib else None,
                     bound_ms=b_ms, bound_by=b_by, bytes=case.rank_bytes(),
                     ops=case.rank_ops(),
                     peak=f"{case.peak} {PEAK_FLOPS[case.peak] / 1e12} "
                          f"TFLOP/s",
                     splits_whole=c["splits_whole"],
                     splits_rank=c["splits_rank"])
            emit("kernels", **r)
            rows.append(r)
    emit("kernels_tp_slices", checks=checks)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"tp: a rank's launch departs from the whole "
                             f"launch's heads: {bad}")
    return checks, rows


def step_allreduces(eng) -> dict:
    """The all-reduces and gathers of the engine's bucket-8 decode step,
    on the mixed path of that bucket's mixed step with every lane's chunk
    and, where the family takes extras, of a first chunk with them, each
    run once eagerly on its static all-padding inputs under `OpTrace`,
    beside the model layout's counts (`graph_audit.allreduces`,
    `gathers`)."""
    from repro_torch.analysis.graph_audit import allreduces, gathers

    keys = [("decode", max(eng.buckets))] + sorted(
        (k for k in eng.graphs.steps if k[0] == "xchunk"), key=str)[:1]
    if eng.mixed:
        keys.append(("mixed", max(eng.buckets), eng.n_lanes))
    out = {}
    for key in keys:
        st = eng._step(key)
        (n, g), _ = count_collectives(st.fn, st.inputs)
        m, tp = eng.model.local_cfg, eng.model.tp
        out[str(key)] = dict(traced=n, layout=allreduces(
            m, tp, key[0] == "xchunk"), gathers=g, gathers_layout=gathers(
            m, tp, key[0] == "xchunk"))
    return out


def counts_hold(counts: dict) -> bool:
    """Every traced step's all-reduces and gathers are the layout's."""
    return all(c["traced"] == c["layout"]
               and c.get("gathers", 0) == c.get("gathers_layout", 0)
               for c in counts.values())


def run_tp_nccl(served, graphs, launches) -> dict:
    """tp (a): a (1, 1) mesh over NCCL at full width in bf16, the serve
    run's flags, its CUDA graphs captured with the all-reduces inside:
    granite-3-8b in both layouts and the TP_MORE archs paged
    (`run_serve`'s checks). The tokens and structural counters of the run
    without a mesh, bit for bit (a one-rank all-reduce is the identity);
    the replay checks of `run_graph_check` with their replay times beside
    the no-mesh engine's; each engine's all-reduces a forward, traced on
    its decode step (and first chunk), equal to the layout's count; and
    the graph audit of the reduced one-rank mesh engines of
    `graph_audit.MESH_ARCHS` on the same group (every step's all-reduces
    counted against the layout's)."""
    import tempfile

    from repro_torch.analysis.graph_audit import GraphAudit
    from repro_torch.launch.mesh import close_serving_group, make_serving_group

    out, bad = {}, {}
    runs = [(TP_ARCH, False), (TP_ARCH, True)] + [(a, True) for a in TP_MORE]
    with tempfile.TemporaryDirectory() as d:
        group = make_serving_group((1, 1), "nccl", 0, 1,
                                   init_method=f"file://{d}/store")
        try:
            for arch, paged in runs:
                t0 = time.perf_counter()
                layout = "paged" if paged else "contiguous"
                fields, eng, reqs = run_serve(arch, paged, mesh=(1, 1))
                for k, n in fields["launches"].items():
                    launches[k] = launches.get(k, 0) + n
                check = run_graph_check(eng, f"{arch}_{layout}_mesh1x1")
                counts = step_allreduces(eng)
                del eng
                gc.collect()
                torch.cuda.empty_cache()
                zero, want = served[arch, layout]
                same = [r.output_tokens for r in reqs] \
                    == [r.output_tokens for r in want]
                diff = {k: (zero["summary"][k], fields["summary"][k])
                        for k in STRUCTURAL
                        if zero["summary"][k] != fields["summary"][k]}
                replay = {str(tuple(c["key"])): dict(
                    mesh_ms=c["replay_device_ms"],
                    no_mesh_ms=n["replay_device_ms"])
                    for c, n in zip(check["checks"],
                                    graphs[f"{arch}_{layout}"]["checks"])}
                name = f"{arch}_{layout}"
                out[name] = dict(
                    tokens_equal=same, structural_diff=diff,
                    model_shards=fields["summary"]["model_shards"],
                    replay_device_ms=replay, allreduces=counts,
                    interval_s_mean=fields["interval_s_mean"],
                    no_mesh_interval_s_mean=zero["interval_s_mean"],
                    seconds=time.perf_counter() - t0)
                emit("tp_nccl_run", run=name, **out[name])
                if not same or diff or not counts_hold(counts):
                    bad[name] = (same, diff, counts)
            t0 = time.perf_counter()
            audit = GraphAudit(torch.device("cuda"))
            audit.mesh(group=group)
            out["audit"] = audit.totals()
            out["audit"]["seconds"] = time.perf_counter() - t0
        finally:
            close_serving_group()
    emit("tp_nccl_one_rank", **out)
    if bad or out["audit"]["findings"] \
            or not out["audit"]["collectives"].get("allreduce_"):
        raise AssertionError(f"tp (a): the one-rank NCCL mesh departs from "
                             f"the run without a mesh, or its audit failed: "
                             f"{bad} {out['audit']}")
    return out


def probe_extras(cfg, n: int, enc_len: int):
    """n prompts' extras (n, enc_len, d) in bf16 on the card, drawn on the
    host from seed 3 (the same on every rank), for a VLM or enc-dec
    config; None for the other families."""
    from repro_torch.models.model import default_enc_len

    if not default_enc_len(cfg):
        return None
    g = torch.Generator().manual_seed(3)
    return torch.randn((n, enc_len, cfg.d_model), generator=g).to(
        "cuda", torch.bfloat16)


def _tp_probe(model, params, prompts, T: int, extras=None):
    """The first T tokens of each prompt prefilled as one batch (with the
    prompts' `extras`, (B, S, d), where the family takes them), then one
    decode step on each prompt's token T (the same inputs whatever the
    logits): (last prefill logits, decode logits), fp32 numpy arrays (a
    rank's result crosses to the parent by value)."""
    from repro_torch.models.backbone import extras_key

    dev = model.device
    toks = torch.tensor([p[:T + 1] for p in prompts], device=dev)
    B = toks.shape[0]
    pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    cache = model.init_cache(B, T + 1, prefill_chunk=T,
                             enc_len=0 if extras is None else extras.shape[1])
    pre, cache = model.prefill(
        params, toks[:, :T], pos, cache, last_only=True,
        extras=None if extras is None else {extras_key(model.cfg): extras})
    dec, _ = model.decode_step(params, toks[:, T], torch.full(
        (B,), T, dtype=torch.int32, device=dev), cache)
    return pre[:, -1].float().cpu().numpy(), dec.float().cpu().numpy()


@contextlib.contextmanager
def planted_fault(arch: str, cfg, tp):
    """One all-reduce of each forward dropped, on every rank alike (so the
    collectives still match): granite's last layer's MLP (rank 0 then adds
    its own share only), a MoE's last layer's experts (`layers.moe_sum`
    without the group), a cross family's last cross layer's `wo`
    (`layers.cross_attention` without the group), mamba2's last layer's
    `out_proj` and the hybrid's last recurrent layer's `w_out` (their
    modules' `down_proj` without the group)."""
    import itertools

    from repro_torch.config.base import ArchFamily
    from repro_torch.models import layers as L
    from repro_torch.models import rglru as R
    from repro_torch.models import ssm as S
    from repro_torch.models.backbone import layer_counts, n_cross_layers

    calls = itertools.count()
    if cfg.family in (ArchFamily.SSM, ArchFamily.HYBRID):
        # the module's only down-projection: out_proj / w_out, once a layer
        mod = S if cfg.family == ArchFamily.SSM else R
        keep, n = mod.down_proj, layer_counts(cfg)[1]
        mod.down_proj = lambda x, w, tp=None: keep(x, w) \
            if next(calls) % n == n - 1 else keep(x, w, tp)
        try:
            yield
        finally:
            mod.down_proj = keep
    elif cfg.family == ArchFamily.MOE:
        keep, n = L.moe_sum, cfg.num_layers
        L.moe_sum = lambda r, s, tp=None: keep(r, s) \
            if next(calls) % n == n - 1 else keep(r, s, tp)
        try:
            yield
        finally:
            L.moe_sum = keep
    elif n_cross_layers(cfg):
        keep, n = L.cross_attention, n_cross_layers(cfg)

        def dropped(*a, **kw):
            if next(calls) % n == n - 1:
                kw["tp"] = None
            return keep(*a, **kw)

        L.cross_attention = dropped
        try:
            yield
        finally:
            L.cross_attention = keep
    else:
        # a forward's all-reduces: the embedding's if vocab-sharded (not
        # granite's odd vocab), attention's and the MLP's per layer, the
        # head's; the last layer's MLP one is dropped
        assert tp.mlp_split
        v = int(tp.vocab_split)
        whole, every = tp.reduce, 2 * cfg.num_layers + 2 * v
        tp.reduce = lambda x: x if next(calls) % every == every - 1 - v \
            else whole(x)
        try:
            yield
        finally:
            del tp.reduce


def _tp_cut_probe(group, arch: str, prompts, T: int, picks=None) -> dict:
    """tp (b)'s logit probes (`_tp_probe`) at `arch`'s TP_PROBE_CUTS, full
    width, bf16, seed 0's weights, the gates at 0.5; a cross family's at
    TP_PROBE_ENC_LEN cross keys (held) and at its real length (printed).
    Without a group: the single device's, on the batch and on each prompt
    alone (its own spread: other GEMM and attention launch shapes), a
    MoE's expert picks recorded (`Routing`). On `group`: the rank's model,
    a MoE's run first on its own picks (counting those that differ from
    the single device's `picks`) and then on those; then the same with
    the planted fault (`planted_fault`)."""
    import dataclasses

    import numpy as np
    from repro_torch.config.registry import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.model import build_model, default_enc_len

    cfg = dataclasses.replace(get_config(arch, "full"), **TP_PROBE_CUTS[arch])
    model = build_model(cfg, dtype=torch.bfloat16, device="cuda",
                        group=group)
    params = model.init(0)
    set_gates(params)
    lens = {"held": TP_PROBE_ENC_LEN}
    if default_enc_len(cfg):
        lens["real"] = default_enc_len(cfg)
    moe = cfg.moe is not None
    out = {}
    for which, S in lens.items():
        ex = probe_extras(cfg, len(prompts), S)
        tag = "" if which == "held" else "_real"
        if group is None:
            with Routing(L) as routing:
                out["sound" + tag] = _tp_probe(model, params, prompts, T, ex)
            if moe and which == "held":
                out["picks"] = routing.picks
            rows = [_tp_probe(model, params, [p], T,
                              None if ex is None else ex[i:i + 1])
                    for i, p in enumerate(prompts)]
            out["rows" + tag] = tuple(np.concatenate(r) for r in zip(*rows))
            continue
        with contextlib.ExitStack() as stack:
            if moe:
                with Routing(L) as own:
                    _tp_probe(model, params, prompts, T, ex)
                out["picks_differing_before_replay"] = sum(
                    int((~(a[..., :, None] == b[..., None, :]).any(-1)).sum())
                    for a, b in zip(own.picks, picks))
                out["picks_routed"] = sum(int(a.numel()) for a in picks)
                replay = stack.enter_context(Routing(L))
                replay.replay = True
                replay.picks = list(picks)
            out["sound" + tag] = _tp_probe(model, params, prompts, T, ex)
            if moe:
                replay.picks = list(picks)
            with planted_fault(arch, cfg, model.tp):
                out["fault" + tag] = _tp_probe(model, params, prompts, T, ex)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_gloo_arch(group, rank: int, world: int, arch: str) -> dict:
    """One rank's part of tp (b) for `arch` (`tp_gloo_rank`): rank 0's
    single-device cut probe first (a MoE's expert picks then go to every
    rank), the rank's served runs in TP_GLOO_LAYOUTS (the full-depth
    probe on the first, its all-reduces traced), its cut probe."""
    import numpy as np
    import torch.distributed as dist
    from repro_torch.analysis.graph_audit import allreduces, gathers
    from repro_torch.bench.kv_swap import prompts as make_prompts
    from repro_torch.bench.kv_swap import request_sets
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model, default_enc_len
    from repro_torch.params import named_leaves

    cfg = tp_config(arch)
    n, lo, hi = TP_GLOO_PROMPTS
    prompts = make_prompts(cfg.vocab_size, n, lo, hi)
    mesh = ["--mesh", ",".join(map(str, TP_GLOO_MESH))]
    enc_len = default_enc_len(cfg)
    full_ex = probe_extras(cfg, n, enc_len)
    whole = build_model(cfg, torch.bfloat16, "meta").init(0)
    out = {"prompt_lens": [len(p) for p in prompts],
           "whole_weights_gb": sum(t.numel() * t.element_size() for _, t in
                                   named_leaves(whole)) / 1e9}
    del whole
    single_cut = _tp_cut_probe(None, arch, prompts, lo - 1) \
        if rank == 0 else {}
    box = [single_cut.pop("picks", None)]
    dist.broadcast_object_list(box, src=0, group=group.control)
    picks = box[0]

    def served(argv, probe: bool):
        args = serve.build_parser().parse_args(argv)
        t0 = time.perf_counter()
        eng = serve.build_engine(args, cuda_graphs=False,
                                 cfg=cfg if arch in DEPTH_CUTS else None,
                                 enc_len=enc_len)
        set_gates(eng.params)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        counts = None
        if probe:
            # the probe's all-reduces: a first chunk (with the extras)
            # and a decode step; a decode step alone
            (n_probe, g_probe), _ = count_collectives(
                _tp_probe, eng.model, eng.params, prompts, lo - 1, full_ex)
            (n_dec, g_dec), _ = count_collectives(
                eng.model.decode_step, eng.params,
                torch.zeros(1, dtype=torch.int64, device="cuda"),
                torch.zeros(1, dtype=torch.int32, device="cuda"),
                eng.model.init_cache(1, 8))
            m, tp = eng.model.local_cfg, eng.model.tp
            ex = full_ex is not None
            counts = {
                "probe": dict(traced=n_probe, layout=allreduces(m, tp, ex)
                              + allreduces(m, tp), gathers=g_probe,
                              gathers_layout=gathers(m, tp, ex)
                              + gathers(m, tp)),
                "decode": dict(traced=n_dec, layout=allreduces(m, tp),
                               gathers=g_dec,
                               gathers_layout=gathers(m, tp))}
        mk_extras = serve.extras_drawer(eng, np.random.RandomState(1))
        reqs = [(p, mk_extras()) for p in prompts]
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        hs = [eng.submit(p, extras=x) for p, x in reqs]
        eng.run()
        torch.cuda.synchronize()
        s = eng.summary()
        rec = dict(summary=s, tokens=[h.output_tokens for h in hs],
                   launches=dict(ops.LAUNCHES), build_s=build_s,
                   serve_s=time.perf_counter() - t0,
                   interval_s_mean=s["step_host_s_mean"]
                   + s["step_device_s_mean"],
                   intervals=len(eng.step_host_trace),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   kv_heads=int(eng.cache["k"].shape[-2])
                   if "k" in eng.cache else None,
                   kv_dim=int(eng.cache["k"].shape[-1])
                   if "k" in eng.cache else None,
                   cross_kv_heads=int(eng.cache["cross_k"].shape[-2])
                   if "cross_k" in eng.cache else None,
                   weights_gb=sum(t.numel() * t.element_size() for _, t in
                                  named_leaves(eng.params)) / 1e9,
                   params_b=sum(t.numel() for _, t in
                                named_leaves(eng.params)) / 1e9,
                   prefill_chunk=eng.prefill_chunk,
                   max_context=eng.max_context, requests=hs,
                   allreduces=counts)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return rec

    layouts = TP_GLOO_LAYOUTS[arch]
    for paged in layouts:
        layout = "paged" if paged else "contiguous"
        argv = serve_args(arch) + TP_GLOO_ARGS + mesh \
            + (["--paged"] if paged else [])
        rec = served(argv, probe=paged == layouts[0])
        reqs = rec.pop("requests")
        every = [None] * world
        dist.all_gather_object(every, rec["tokens"], group=group.control)
        rec["ranks_agree"] = all(t == rec["tokens"] for t in every)
        rec["sets"] = request_sets(reqs)
        out[layout] = rec
    out["tp_cut"] = _tp_cut_probe(group, arch, prompts, lo - 1, picks)
    if cfg.ssm is not None:
        out["norm_layer"] = _tp_split_norm(group, cfg)
    if rank == 0:
        out["single_cut"] = single_cut
    dist.barrier(group=group.control)
    return out


def _tp_split_norm(group, cfg, dev="cuda") -> dict:
    """mamba2's gated norm held by a layer check of its own (the logit
    rule may not see its all-reduce dropped: random halves of a row have
    similar mean squares): rows of d_inner drawn from a seed (the same on
    every rank), the rank's channels normed by `ops.rmsnorm_split` over
    the group, against its slice of the rmsnorm kernel's whole rows, within
    ATOL + RTOL · |want|; the same with the reduce dropped, printed."""
    from repro_torch.kernels import ops
    from repro_torch.models.ssm import ssm_dims
    from repro_torch.distributed.sharding import tensor_parallel

    tp = tensor_parallel(cfg, group)
    d = ssm_dims(cfg)[0]
    mine = tp.part(d)
    g = torch.Generator(device=dev).manual_seed(9)
    out = {}
    for rows in SPLIT_ROWS:
        x = torch.randn((rows, d), generator=g, device=dev).to(
            torch.bfloat16)
        w = (torch.randn((d,), generator=g, device=dev) * 0.1).to(
            torch.bfloat16)
        want = ops.rmsnorm(x, w, eps=cfg.rms_eps)[:, mine]
        xr, wr = x[:, mine].contiguous(), w[mine].contiguous()
        got = ops.rmsnorm_split(xr, wr, d=d, eps=cfg.rms_eps,
                                reduce=tp.reduce)
        dropped = ops.rmsnorm_split(xr, wr, d=d, eps=cfg.rms_eps)
        scale = float(want.float().abs().max())
        out[f"rows={rows}"] = dict(
            max_abs_err=max_err(got, want),
            dropped_rel=float((dropped.float() - want.float()).abs().max())
            / scale)
    return out


def tp_gloo_rank(rank: int, world: int) -> dict:
    """One rank of tp (b): each of TP_ARCH and TP_MORE at full width (the
    VLM at its DEPTH_CUTS) in bf16 on this rank's half of the heads (a
    MoE's half of the experts), on the card, with a gloo group
    (`cuda_graphs=False`: gloo's collectives cannot be captured), through
    `launch.serve.build_engine` (`_tp_gloo_arch`). Returns rank 0's
    records, by arch."""
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import make_serving_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    group = make_serving_group(TP_GLOO_MESH, "gloo", rank, world)
    out = {}
    for arch in (TP_ARCH,) + TP_MORE:
        t0 = time.perf_counter()
        out[arch] = _tp_gloo_arch(group, rank, world, arch)
        out[arch]["seconds"] = time.perf_counter() - t0
    return out


def _rel(got, want) -> dict:
    return {k: float(abs(a - b).max() / abs(b).max())
            for k, a, b in zip(("prefill", "decode"), got, want)}


def _tp_gloo_check(arch: str, res: dict, launches) -> tuple:
    """tp (b)'s checks of one arch (`run_tp_gloo`): (the printed record,
    the failures)."""
    from repro_torch.bench.kv_swap import prompts as make_prompts
    from repro_torch.bench.kv_swap import sim_twin
    from repro_torch.core.memory_model import kv_shard_factor
    from repro_torch.launch import serve

    cfg = tp_config(arch)
    shards = kv_shard_factor(cfg, TP_GLOO_MESH[-1])
    tp_cut, one_cut = res.pop("tp_cut"), res.pop("single_cut")
    cut = {"tp": _rel(tp_cut["sound"], one_cut["sound"]),
           "single_rows": _rel(one_cut["rows"], one_cut["sound"]),
           "fault": _rel(tp_cut["fault"], one_cut["sound"])}
    if "sound_real" in tp_cut:
        cut["real_length"] = dict(
            tp=_rel(tp_cut["sound_real"], one_cut["sound_real"]),
            single_rows=_rel(one_cut["rows_real"], one_cut["sound_real"]),
            fault=_rel(tp_cut["fault_real"], one_cut["sound_real"]))
    for k in ("picks_differing_before_replay", "picks_routed"):
        if k in tp_cut:
            cut[k] = tp_cut[k]
    bad = []
    out = dict(seconds=res["seconds"], logits_rel_err=dict(
        cut, layers=TP_PROBE_CUTS[arch], tol=TP_LOGIT_TOL),
        whole_weights_gb=res["whole_weights_gb"])
    if "norm_layer" in res:
        # max_err raised on the rank had a row been out of tolerance
        out["norm_layer"] = res["norm_layer"]
    for k in ("prefill", "decode"):
        if cut["tp"][k] > TP_LOGIT_TOL:
            bad.append(f"{arch} {k} logits {cut['tp'][k]} at "
                       f"{TP_PROBE_CUTS[arch]}")
        if cut["fault"][k] <= TP_LOGIT_TOL:
            bad.append(f"{arch}: the planted fault's {k} logits "
                       f"{cut['fault'][k]} pass the rule")
    n, lo, hi = TP_GLOO_PROMPTS
    prompts = make_prompts(cfg.vocab_size, n, lo, hi)
    _, fpath, attends, (fused, plain), per_forward = FAMILIES[arch]
    if arch in MESH_NORMS:
        (fused, plain), more = MESH_NORMS[arch]
        per_forward = dict(per_forward, **more)
    for paged in TP_GLOO_LAYOUTS[arch]:
        layout = "paged" if paged else "contiguous"
        rec = res[layout]
        args = serve.build_parser().parse_args(
            serve_args(arch) + TP_GLOO_ARGS
            + ["--mesh", ",".join(map(str, TP_GLOO_MESH))]
            + (["--paged"] if paged else []))
        twin = sim_twin(args, [prompts], args.max_new,
                        rec["prefill_chunk"], rec["max_context"], cfg=cfg)
        s = rec["summary"]
        twin_diff = {k: (s[k], twin[k]) for k in TWIN if s[k] != twin[k]}
        if rec["sets"] != twin["sets"]:
            twin_diff["sets"] = (rec["sets"], twin["sets"])
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
        # a first chunk's encoder (eager: one a request admitted)
        first = {k: v * s["admitted"]
                 for k, v in FIRST_CHUNK.get(arch, {}).items()}
        fwd_launches = {k: v - first.get(k, 0)
                        for k, v in rec["launches"].items()}
        out[layout] = dict(
            ranks_agree=rec["ranks_agree"],
            finished=s["finished"], model_shards=s["model_shards"],
            pool_tokens=s["pool_tokens"], twin_diff=twin_diff,
            kv_heads=rec["kv_heads"], kv_dim=rec["kv_dim"],
            cross_kv_heads=rec["cross_kv_heads"],
            weights_gb=rec["weights_gb"], params_b=rec["params_b"],
            interval_s_mean=rec["interval_s_mean"],
            step_host_s_mean=s["step_host_s_mean"],
            step_device_s_mean=s["step_device_s_mean"],
            intervals=rec["intervals"], build_s=rec["build_s"],
            serve_s=rec["serve_s"], peak_mem_gb=rec["peak_mem_gb"],
            launches=rec["launches"], allreduces=rec["allreduces"])
        if not rec["ranks_agree"]:
            bad.append(f"{arch} {layout}: the ranks' tokens differ")
        if s["finished"] != n or s["model_shards"] != shards \
                or s["pool_tokens"] != shards * 8192:
            bad.append(f"{arch} {layout}: finished {s['finished']}, shards "
                       f"{s['model_shards']}, pool {s['pool_tokens']}")
        if twin_diff:
            bad.append(f"{arch} {layout}: engine and simulator differ "
                       f"{twin_diff}")
        if rec["allreduces"] and not counts_hold(rec["allreduces"]):
            bad.append(f"{arch} {layout}: all-reduces {rec['allreduces']}")
        path = fpath + tuple(per_forward) \
            + (ATTENTION[paged] if attends else ())
        other = ATTENTION[not paged]
        if any(fwd_launches[k] <= 0 for k in path if per_forward.get(k, 1)) \
                or any(fwd_launches[k] for k in other):
            bad.append(f"{arch} {layout}: launches {rec['launches']}")
        fwd = fwd_launches["rmsnorm"] // plain
        if fwd_launches["add_rmsnorm"] != fused * fwd or any(
                fwd_launches[k] != c * fwd for k, c in per_forward.items()):
            bad.append(f"{arch} {layout}: {fwd_launches} in {fwd} "
                       f"forwards, not {fused} + {plain} norms and "
                       f"{per_forward} a forward")
    return out, bad


def run_tp_gloo(card: str, launches) -> dict:
    """tp (b): two gloo ranks on the one card (`tp_gloo_rank`, spawned by
    `launch.mesh.spawn_ranks`), for TP_ARCH and TP_MORE: both ranks decode
    the same tokens in each of TP_GLOO_LAYOUTS; at the TP_PROBE_CUTS depth
    the first decode step's logits and the prefill's last within
    TP_LOGIT_TOL of max|logit| of the single-device bf16 step's, and the
    planted fault's beyond it (`_tp_cut_probe`; the single device's own
    spread beside them; a MoE on the single device's expert picks, the
    picks that differed before the replay counted); a forward's
    all-reduces, traced on the full-depth probe, equal to the layout's
    count; the counters equal to the port's simulator on the same flags
    with `mesh_shape` (1, 2) (`model_shards` 2, mamba2's 1); mamba2's
    gated norm held by a layer check of its own (`_tp_split_norm`);
    weights a rank beside the whole model's; interval times beside the
    card's name and power limit.
    A correctness path: gloo copies each all-reduce through the host, so
    no speed is claimed from it."""
    from repro_torch.launch.mesh import spawn_ranks

    t0 = time.perf_counter()
    res = spawn_ranks(tp_gloo_rank, math.prod(TP_GLOO_MESH), timeout_s=1000)
    out, bad = dict(card=card), []
    for arch in (TP_ARCH,) + TP_MORE:
        out[arch], why = _tp_gloo_check(arch, res[arch], launches)
        bad += why
        emit("tp_gloo_arch", arch=arch, card=card, **out[arch])
    out["seconds"] = time.perf_counter() - t0
    emit("tp_gloo_two_ranks", **out)
    if bad:
        raise AssertionError(f"tp (b): {bad}")
    return out


# ---------------------------------------------------------------------------
# tp (d): the layouts the port once refused, eager on gloo ranks

#: name -> (arch, mesh) of the cut-depth probes: starcoder2-7b's 36 query
#: heads cut over 8 ranks (its 4 kv-heads on the head_dim fallback, q
#: gathered a layer), llama-3.2-vision-90b's cross K/V on the fallback
#: over 16 (8 kv-heads), both at TP_PROBE_CUTS
TP_LAYOUTS = {"split_heads": ("starcoder2-7b", (1, 8)),
              "cross_fallback": ("llama-3.2-vision-90b", (1, 16))}
#: the sequence-sharded decode's probe: mistral-nemo-12b `sliding(4096)`
#: at TP_PROBE_LAYERS layers on a (2, 1) mesh, batch 1: (window, prefill
#: chunk, prompt tokens): the ring (window + chunk - 1 slots, cut in two
#: by `cache_specs(seq_shard=True)`: 2176 a rank) wrapped by the prompt,
#: then SEQ_PROBE_STEPS decode steps
SEQ_PROBE_MESH = (2, 1)
SEQ_PROBE_RING = (4096, 257, 4600)
SEQ_PROBE_STEPS = 16


def layout_fault(name: str):
    """tp (d)'s planted faults, on every rank alike (no collective is left
    unmatched): `split_heads`, the q gather replaced by the rank's own
    columns (the other ranks' columns of its head span read as zeros);
    `cross_fallback`, each cross layer's slab read without its gather
    (the rank's hd/m channels, the others zeros)."""
    from repro_torch.distributed.sharding import TensorParallel
    from repro_torch.models import layers as L

    @contextlib.contextmanager
    def own_columns(model):
        keep = TensorParallel.q_heads

        def q_heads(self, q):
            hd = self.whole.resolved_head_dim
            n = q.shape[-1]
            whole = q.new_zeros(q.shape[:-1] + (n * self.m,))
            whole[..., self.rank * n:(self.rank + 1) * n] = q
            h0, h1 = self.heads
            return whole[..., h0 * hd:h1 * hd].unflatten(-1, (-1, hd))

        TensorParallel.q_heads = q_heads
        try:
            yield
        finally:
            TensorParallel.q_heads = keep

    @contextlib.contextmanager
    def ungathered_cross(model):
        keep_cross, keep_read = L.cross_attention, L.kv_read

        def read(k, v, tp=None):
            def pad(t):
                whole = t.new_zeros(t.shape[:-1] + (t.shape[-1] * tp.m,))
                c = t.shape[-1]
                whole[..., tp.rank * c:(tp.rank + 1) * c] = t
                return tp.kv_span(whole)
            return pad(k), pad(v)

        def cross(*a, **kw):
            L.kv_read = read
            try:
                return keep_cross(*a, **kw)
            finally:
                L.kv_read = keep_read

        L.cross_attention = cross
        try:
            yield
        finally:
            L.cross_attention = keep_cross

    return {"split_heads": own_columns,
            "cross_fallback": ungathered_cross}[name]


def _layout_probe(group, arch: str, prompts, T: int, fault=None) -> dict:
    """`_tp_probe` at `arch`'s TP_PROBE_CUTS, full width, bf16, seed 0's
    weights, gates 0.5, TP_PROBE_ENC_LEN cross keys: the single device's
    without a group; on `group` the rank's, its all-reduces and gathers
    traced beside the layout's (`graph_audit`), then under `fault`."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.analysis.graph_audit import allreduces, gathers
    from repro_torch.config.registry import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config(arch, "full"), **TP_PROBE_CUTS[arch])
    model = build_model(cfg, dtype=torch.bfloat16, device="cuda",
                        group=group)
    if group is None:
        params = model.init(0)
    else:
        # one rank draws at a time: each holds a whole tensor while it
        # cuts it (the VLM's embedding is 2.1 GB), which 16 ranks at once
        # do not fit beside their contexts; the freed blocks go back to
        # the device before the next rank draws
        for turn in range(group.world):
            if turn == group.rank:
                params = model.init(0)
                torch.cuda.empty_cache()
            dist.barrier(group=group.control)
    set_gates(params)
    ex = probe_extras(cfg, len(prompts), TP_PROBE_ENC_LEN)
    (n, g), logits = count_collectives(_tp_probe, model, params, prompts, T,
                                       ex)
    out = {"sound": logits}
    if group is not None:
        m, tp = model.local_cfg, model.tp
        out["collectives"] = dict(
            allreduces=n, gathers=g, q_gather=tp.q_gather,
            layout_allreduces=allreduces(m, tp, ex is not None)
            + allreduces(m, tp),
            layout_gathers=gathers(m, tp, ex is not None) + gathers(m, tp))
        with fault(model):
            out["fault"] = _tp_probe(model, params, prompts, T, ex)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _layout_rank(group, name: str) -> dict:
    """One rank of a TP_LAYOUTS probe: rank 0's single-device probe first
    (the others wait), then every rank's own and its fault's; the ranks'
    decode argmax gathered. Returns the rank's record (rank 0's holds the
    single device's)."""
    import torch.distributed as dist
    from repro_torch.bench.kv_swap import prompts as make_prompts
    from repro_torch.config.registry import get_config

    arch, _ = TP_LAYOUTS[name]
    rank, world = group.rank, group.world
    n, lo, hi = TP_GLOO_PROMPTS
    prompts = make_prompts(get_config(arch, "full").vocab_size, n, lo, hi)
    t0 = time.perf_counter()
    one = _layout_probe(None, arch, prompts, lo - 1) if rank == 0 else None
    dist.barrier(group=group.control)
    mine = _layout_probe(group, arch, prompts, lo - 1, layout_fault(name))
    every = [None] * world
    dist.all_gather_object(every, mine["sound"][1].argmax(-1).tolist(),
                           group=group.control)
    return dict(single=one, tp=mine, ranks_agree=all(
        t == every[0] for t in every), seconds=time.perf_counter() - t0)


def _seq_cut(cache, sizes, d: int):
    """Data rank d's share of a contiguous cache by `cache_specs(seq_shard=
    True)`: each leaf narrowed on its "data" axis, whole elsewhere."""
    from repro_torch.distributed.sharding import cache_specs

    specs = cache_specs(cache, sizes, seq_shard=True)
    out = {}
    for k, t in cache.items():
        spec = specs[k]
        if "data" in spec:
            ax = spec.index("data")
            n = t.shape[ax] // sizes["data"]
            t = t.narrow(ax, d * n, n)
        out[k] = t.clone()
    return out


def _seq_rank(group) -> dict:
    """One data rank of the sequence-sharded probe (SEQ_PROBE_RING): the
    whole cache prefilled on the rank's own device in chunks (the single
    device's: a model axis of 1 holds the whole weights), its slots cut
    by `cache_specs(seq_shard=True)`, then SEQ_PROBE_STEPS decode steps
    through `Model.decode_step(seq_shard=True)` against the single
    device's steps on the whole cache, a step's collectives traced, and
    again with each rank combining its own partial only (the gather over
    "data" skipped on every rank). Returns the rank's record: the
    logits' gaps from the single device's, the collectives, its
    launches."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist
    from repro_torch.analysis.graph_audit import allreduces, gathers
    from repro_torch.configs.mistral_nemo_12b import sliding
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    world = group.world
    sizes = {"data": SEQ_PROBE_MESH[0], "model": SEQ_PROBE_MESH[1]}
    launches = dict.fromkeys(ops.LAUNCHES, 0)
    window, chunk, P = SEQ_PROBE_RING
    t0 = time.perf_counter()
    cfg = dataclasses.replace(sliding(window), num_layers=TP_PROBE_LAYERS)
    model = build_model(cfg, torch.bfloat16, "cuda", group=group)
    one = build_model(cfg, torch.bfloat16, "cuda")
    params = model.init(0)       # a model axis of 1: the whole weights
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (1, P + SEQ_PROBE_STEPS),
                         generator=g).cuda()
    whole = one.init_cache(1, P + SEQ_PROBE_STEPS, prefill_chunk=chunk)
    for s0 in range(0, P, chunk):
        s1 = min(s0 + chunk, P)
        pos = torch.arange(s0, s1, dtype=torch.int32,
                           device="cuda")[None]
        one.prefill(params, toks[:, s0:s1], pos, whole, last_only=True)
    mine = _seq_cut(whole, sizes, group.data_rank)
    fault_cache = {k: t.clone() for k, t in mine.items()}

    def steps(fn, cache):
        rows = []
        for t in range(P, P + SEQ_PROBE_STEPS):
            lg, _ = fn(params, toks[:, t], torch.tensor(
                [t], dtype=torch.int32, device="cuda"), cache)
            rows.append(lg[0].float().cpu().numpy())
        return np.stack(rows)

    want = steps(one.decode_step, whole)
    ops.reset_launches()
    (n_ar, n_g), _ = count_collectives(
        model.decode_step, params, toks[:, P], torch.tensor(
            [P], dtype=torch.int32, device="cuda"),
        {k: t.clone() for k, t in mine.items()}, True)
    got = steps(lambda *a: model.decode_step(*a, seq_shard=True), mine)
    for k, v in ops.LAUNCHES.items():
        launches[k] += v
    gather_data = group.gather_data
    group.gather_data = lambda x: x[None]
    try:
        fault = steps(lambda *a: model.decode_step(*a, seq_shard=True),
                      fault_cache)
    finally:
        group.gather_data = gather_data
    every = [None] * world
    dist.all_gather_object(every, got.argmax(-1).tolist(),
                           group=group.control)
    m, tp = model.local_cfg, model.tp
    scale = float(np.abs(want).max())
    out = dict(
        window=window, ring_slots=int(whole["k"].shape[2]),
        slots_a_rank=int(mine["k"].shape[2]), prompt=P,
        steps=SEQ_PROBE_STEPS, tol=TP_LOGIT_TOL,
        rel=float(np.abs(got - want).max()) / scale,
        fault_rel=float(np.abs(fault - want).max()) / scale,
        argmax_equal_single=float((got.argmax(-1)
                                   == want.argmax(-1)).mean()),
        ranks_agree=all(t == every[0] for t in every),
        collectives=dict(allreduces=n_ar, gathers=n_g,
                         layout_allreduces=allreduces(m, tp),
                         layout_gathers=gathers(m, tp, seq=True)),
        seconds=time.perf_counter() - t0)
    out["launches"] = launches
    return out


def tp_layouts_rank(rank: int, world: int) -> dict:
    """One rank of tp (d): every probe's mesh laid on the first ranks of
    one spawn (`launch.mesh.mesh_group`), so the ranks start once: the
    TP_LAYOUTS probes, then the sequence-sharded one (SEQ_PROBE_MESH); a
    rank past a probe's mesh goes on to the next. Returns rank 0's
    records, by probe."""
    sys.path.insert(0, str(SRC))
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_serving_group, mesh_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    meshes = [mesh for _, mesh in TP_LAYOUTS.values()] + [SEQ_PROBE_MESH]
    make_serving_group((1, world), "gloo", rank, world)
    groups = [mesh_group(mesh, "gloo", rank) for mesh in meshes]
    out = {}
    for name, group in zip(list(TP_LAYOUTS) + ["seq"], groups):
        if group is not None:
            out[name] = _seq_rank(group) if name == "seq" \
                else _layout_rank(group, name)
    dist.barrier()                 # every rank leaves with the last probe
    return out


def run_tp_layouts(card: str, launches) -> dict:
    """tp (d): the layouts the port once refused, on the one card, eager,
    on gloo ranks of one spawn (`tp_layouts_rank`): starcoder2-7b's split
    query heads on (1, 8) and llama-3.2-vision-90b's cross K/V on the
    head_dim fallback on (1, 16), at TP_PROBE_CUTS (the first decode
    step's and the prefill's last logits within TP_LOGIT_TOL of max|logit|
    of one device's, the planted fault beyond it, the ranks' tokens equal,
    the all-reduces and gathers the layout's); and the sequence-sharded
    decode on (2, 1) (`_seq_rank`; its partial and combine launches join
    `launches`). A correctness path: no speed is claimed."""
    from repro_torch.launch.mesh import spawn_ranks

    world = max(math.prod(mesh) for _, mesh in TP_LAYOUTS.values())
    t0 = time.perf_counter()
    every = spawn_ranks(tp_layouts_rank, world, timeout_s=900)
    out, bad = dict(card=card, seconds=time.perf_counter() - t0), []
    for name, (arch, mesh) in TP_LAYOUTS.items():
        res = every[name]
        one, tp = res["single"]["sound"], res["tp"]
        rec = dict(arch=arch, mesh=list(mesh), layers=TP_PROBE_CUTS[arch],
                   tol=TP_LOGIT_TOL, tp=_rel(tp["sound"], one),
                   fault=_rel(tp["fault"], one),
                   ranks_agree=res["ranks_agree"],
                   collectives=tp["collectives"], seconds=res["seconds"])
        out[name] = rec
        emit("tp_layout", name=name, card=card, **rec)
        c = tp["collectives"]
        for k in ("prefill", "decode"):
            if rec["tp"][k] > TP_LOGIT_TOL:
                bad.append(f"{name} {k} logits {rec['tp'][k]}")
            if rec["fault"][k] <= TP_LOGIT_TOL:
                bad.append(f"{name}: the planted fault's {k} logits "
                           f"{rec['fault'][k]} pass the rule")
        if not res["ranks_agree"] or (c["allreduces"], c["gathers"]) != (
                c["layout_allreduces"], c["layout_gathers"]):
            bad.append(f"{name}: ranks agree {res['ranks_agree']}, "
                       f"collectives {c}")
    rec = every["seq"]
    for k, n in rec.pop("launches").items():
        launches[k] = launches.get(k, 0) + n
    emit("tp_seq", card=card, **rec)
    c = rec["collectives"]
    if (c["allreduces"], c["gathers"]) != (c["layout_allreduces"],
                                           c["layout_gathers"]) \
            or not rec["ranks_agree"]:
        bad.append(f"seq: ranks agree {rec['ranks_agree']}, collectives {c}")
    if rec["rel"] > TP_LOGIT_TOL:
        bad.append(f"seq: logits {rec['rel']}")
    if rec["fault_rel"] <= TP_LOGIT_TOL:
        bad.append(f"seq: the planted fault's logits {rec['fault_rel']} "
                   f"pass the rule")
    out["seq"] = rec
    if bad:
        raise AssertionError(f"tp (d): {bad}")
    return out


# ---------------------------------------------------------------------------
# the memory tiers (DESIGN §10, §11): granite-3-8b on the paged pool

TIER_ARCH = "granite-3-8b"
#: the port's simulator's figures for the tier runs, printed beside the
#: engine's (`serving/sim.py`, CPU, before the first chip run)
TIER_PREDICTION = {"recompute": {"preemptions": 2, "swap_outs": 0},
                   "swap": {"swap_outs": 3, "swap_ins": 3},
                   "prefix": {"prefix_hit_rate": 0.558,
                              "ttft_mean_s": {"off": 0.726, "on": 0.396}}}
#: the engine-vs-simulator counters of the tier runs
TIER_TWIN = TWIN + ("swap_outs", "swap_ins", "swap_out_bytes",
                    "swap_in_bytes")


def _pool_rows(eng, ids):
    """Clones of the K, V and pos pool rows of blocks `ids`: the ids staged
    through the engine's pinned arena, the gathers queued on the stream
    (no wait)."""
    idx = eng._ids(ids)
    return {k: eng.cache[k].index_select(0 if k == "pos" else 1,
                                         idx).clone()
            for k in ("k", "v", "pos")}


def watch_swaps(eng, log: dict) -> None:
    """Wrap the engine's `_swap_out` and `_swap_in_next` from outside: at
    each swap-out snapshot the victim's pool rows, at each swap-in the rows
    at its new block ids (compared after the run, so the serve run waits
    on nothing), and the interval index of each."""
    swap_out, swap_in = eng._swap_out, eng._swap_in_next
    log.update(taken={}, restored=[], out_at=[], in_at=[])

    def out_spy(slot, r):
        log["taken"][r.rid] = _pool_rows(eng, eng.blocks.table(r.rid))
        log["out_at"].append(len(eng.step_host_trace))
        return swap_out(slot, r)

    def in_spy():
        rid = eng.swapped[0].rid
        ok = swap_in()
        if ok:
            log["restored"].append(
                (log["taken"].pop(rid), _pool_rows(eng,
                                                   eng.blocks.table(rid))))
            log["in_at"].append(len(eng.step_host_trace))
        return ok

    eng._swap_out, eng._swap_in_next = out_spy, in_spy


def round_trip_check(log: dict, name: str) -> dict:
    """Every swap-in restored the swapped-out rows bit for bit."""
    torch.cuda.synchronize()
    same = [all(bool(torch.equal(a[k], b[k])) for k in a)
            for a, b in log["restored"]]
    out = dict(round_trips=len(same), bit_equal=all(same) and bool(same),
               blocks=[int(a["pos"].shape[0]) for a, _ in log["restored"]])
    if not out["bit_equal"]:
        raise AssertionError(f"{name}: a swap round trip changed the pool "
                             f"rows: {same}")
    return out


def run_tier(kind: str, mode: str, depth: int = 0, watch: bool = False):
    """One memory-tier serve run through `repro_torch.bench.kv_swap` or
    `bench.prefix_caching` (their `serve_waves`: `launch.serve`'s
    `build_engine` on chip_smoke's serve flags plus the tier's), its
    launches counted, at overlap depth `depth`. Returns (name, the bench's
    result, the launches, the swap log)."""
    from repro_torch.bench import kv_swap, prefix_caching
    from repro_torch.config.registry import get_config
    from repro_torch.kernels import ops

    base = SERVE_ARGS + ["--arch", TIER_ARCH]
    if kind == "swap":
        argv, waves = kv_swap.swap_argv(mode, base), \
            [serve_prompts(TIER_ARCH)]
    else:
        argv = prefix_caching.prefix_argv(mode, base)
        waves = prefix_caching.waves(get_config(TIER_ARCH,
                                                "full").vocab_size)
    argv += ["--overlap-depth", str(depth)]
    log: dict = {}

    def on_built(eng):
        if watch:
            watch_swaps(eng, log)
        ops.reset_launches()

    out = kv_swap.serve_waves(argv, waves, on_built=on_built)
    launches = dict(ops.LAUNCHES)
    name = f"tiers_{TIER_ARCH}_" + (mode if kind == "swap"
                                    else f"prefix_{mode}") \
        + (f"_overlap{depth}" if depth else "")
    return name, out, launches, log


def check_tier_run(name: str, out: dict, launches: dict, n_req: int):
    """All requests finish, the allocator and host pool end full, and the
    run attends through the block table only."""
    m, eng = out["metrics"], out["engine"]
    if m["finished"] != n_req or not m["allocator_full"] \
            or m["host_blocks_free"] != eng.serve.swap_space_blocks \
            * eng.swap:
        raise AssertionError(f"{name}: {m['finished']} of {n_req} "
                             f"finished, allocator full "
                             f"{m['allocator_full']}, host blocks free "
                             f"{m['host_blocks_free']}")
    if any(launches[k] for k in ATTENTION[False]) \
            or not all(launches[k] for k in ATTENTION[True]):
        raise AssertionError(f"{name}: not only the paged attention "
                             f"kernels launched: {launches}")
    if eng._inflight or any(st.graph is None
                            for st in eng.graphs.steps.values()):
        raise AssertionError(f"{name}: intervals left in flight or a step "
                             f"without its graph")


def tier_twin(out: dict) -> tuple:
    """(engine, simulator) on TIER_TWIN and the request sets."""
    from repro_torch.bench.kv_swap import request_sets

    m = out["metrics"]
    eng = {k: m[k] for k in TIER_TWIN} | request_sets(out["requests"])
    sim = {k: out["sim"][k] for k in TIER_TWIN} | out["sim"]["sets"]
    return eng, sim


def run_tiers():
    """The swap tier and prefix sharing at full width: recompute and swap
    (depth 0 and 2) under the 1536-token pool, prefix sharing off and on
    over the shared-system-prompt waves, each held against the port's
    simulator on the same stream. Returns (the figures, the launches, the
    depth-0 swap engine and its swap log, for `profile_swap`)."""
    n_req = len(serve_prompts(TIER_ARCH))
    figures, launches, twins = {}, {}, {}
    keep = None

    def add(lc):
        for k, n in lc.items():
            launches[k] = launches.get(k, 0) + n

    runs = {}
    for mode, depth in (("recompute", 0), ("swap", 0), ("swap", 2)):
        name, out, lc, log = run_tier("swap", mode, depth,
                                      watch=mode == "swap")
        check_tier_run(name, out, lc, n_req)
        m = out["metrics"]
        fields = dict(metrics=m, launches=lc,
                      prediction=TIER_PREDICTION[mode],
                      sim={k: out["sim"][k] for k in TIER_TWIN},
                      swapped_mib=m["swap_out_bytes"] / 2 ** 20)
        if mode == "swap":
            fields["round_trip"] = round_trip_check(log, name)
            fields["swap_intervals"] = dict(out=log["out_at"],
                                            into=log["in_at"])
        emit(name, **fields)
        add(lc)
        if mode == "recompute" and (m["preemptions"] < 1
                                    or m["swap_outs"] != 0):
            raise AssertionError(f"{name}: {m['preemptions']} preemptions, "
                                 f"{m['swap_outs']} swap-outs")
        if mode == "swap" and (m["swap_outs"] < 1
                               or m["swap_ins"] != m["swap_outs"]):
            raise AssertionError(f"{name}: {m['swap_outs']} swap-outs, "
                                 f"{m['swap_ins']} swap-ins")
        twins[f"{mode}_depth{depth}"] = tier_twin(out)
        runs[mode, depth] = out
        figures[name] = fields
        if (mode, depth) == ("swap", 0):
            keep = (out["engine"], log, out["requests"])
        else:
            out.pop("engine")
        del out
        gc.collect()
        torch.cuda.empty_cache()
    zero, two = runs["swap", 0], runs["swap", 2]
    diff = {k: (zero["metrics"][k], two["metrics"][k])
            for k in STRUCTURAL + TIER_TWIN[-4:]
            if zero["metrics"][k] != two["metrics"][k]}
    if zero["tokens"] != two["tokens"] or diff:
        raise AssertionError(f"swap: the depth-{OVERLAP_DEPTH} run's tokens "
                             f"or counters differ from depth 0's: {diff}")

    prefix = {}
    for mode in ("off", "on"):
        name, out, lc, _ = run_tier("prefix", mode)
        check_tier_run(name, out, lc, len(out["requests"]))
        m = out["metrics"]
        emit(name, metrics=m, launches=lc, sim={
            k: out["sim"][k] for k in ("prefix_hit_rate",
                                       "prefix_hit_tokens",
                                       "prefix_query_tokens",
                                       "ttft_mean_s", "ttft_p90_s")},
             prediction=TIER_PREDICTION["prefix"])
        add(lc)
        twins[f"prefix_{mode}"] = tier_twin(out)
        out.pop("engine")
        prefix[mode] = out
        figures[name] = dict(metrics=m, launches=lc)
        gc.collect()
        torch.cuda.empty_cache()
    off, on = prefix["off"]["metrics"], prefix["on"]["metrics"]
    sim_on = prefix["on"]["sim"]
    same = [a == b for a, b in zip(prefix["off"]["tokens"],
                                   prefix["on"]["tokens"])]
    check = dict(
        hit_rate=dict(engine=on["prefix_hit_rate"],
                      sim=sim_on["prefix_hit_rate"]),
        hit_tokens=dict(engine=on["prefix_hit_tokens"],
                        sim=sim_on["prefix_hit_tokens"]),
        copy_bytes=on["copy_bytes"],
        prefill_tokens=dict(off=off["prefill_tokens"],
                            on=on["prefill_tokens"]),
        ttft_mean_s=dict(off=off["ttft_mean_s"], on=on["ttft_mean_s"]),
        ttft_p90_s=dict(off=off["ttft_p90_s"], on=on["ttft_p90_s"]),
        tokens_equal_share=sum(same) / len(same),
        requests=len(same))
    emit(f"tiers_{TIER_ARCH}_prefix", **check,
         prediction=TIER_PREDICTION["prefix"])
    if on["prefix_hit_rate"] != sim_on["prefix_hit_rate"] \
            or on["prefix_hit_tokens"] != sim_on["prefix_hit_tokens"] \
            or on["copy_bytes"] != 0 or on["prefix_hit_tokens"] <= 0:
        raise AssertionError(f"prefix: the engine's hits differ from the "
                             f"simulator's, or a block was copied: {check}")
    if off["preemptions"] == on["preemptions"] == 0 \
            and on["prefill_tokens"] != off["prefill_tokens"] \
            - on["prefix_hit_tokens"]:
        raise AssertionError(f"prefix: prefill tokens not reduced by the "
                             f"hit tokens: {check}")
    figures["prefix_check"] = check

    bad = {f"{run} {k}": (e[k], s[k]) for run, (e, s) in twins.items()
           for k in e if e[k] != s[k]}
    emit(f"twin_tiers_{TIER_ARCH}", **{run: dict(engine=e, sim=s)
                                       for run, (e, s) in twins.items()})
    if bad:
        raise AssertionError(f"twin tiers: the engine and the simulator "
                             f"disagree: {bad}")
    figures["twin"] = {run: e for run, (e, _) in twins.items()}
    return figures, launches, keep


#: prefix_reference: system prompt, the two users' suffixes (tokens)
PREFIX_REF = (256, 40, 50)


def run_prefix_reference(dev):
    """Granite at 2 layers, full width, bf16, on the paged pool: request A
    (system + user A) prefilled into a fresh pool, then request B reads
    A's system blocks through its table and prefills only its suffix; B's
    last-position logits against B prefilled whole into a fresh pool,
    within 5e-2 of max|logit|. 16-token chunks, as the engine runs."""
    import dataclasses
    from repro_torch.config.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    sys_len, ua, ub = PREFIX_REF
    bs, chunk = 16, 16
    cfg = dataclasses.replace(get_config(TIER_ARCH, "full"), num_layers=2)
    m = build_model(cfg, torch.bfloat16, dev)
    params = m.init(0)
    g = torch.Generator().manual_seed(0)
    system, a_user, b_user = (torch.randint(0, cfg.vocab_size, (n,),
                                            generator=g).tolist()
                              for n in PREFIX_REF)

    def prefill(cache, table, toks, start):
        """Chunks of `toks[start:]` at their positions through `table`;
        the last chunk's last-position logits."""
        tbl = torch.full((1, 64), -1, dtype=torch.int32, device=dev)
        tbl[0, :len(table)] = torch.tensor(table, dtype=torch.int32)
        lg = None
        for s0 in range(start, len(toks), chunk):
            piece = toks[s0:s0 + chunk]
            t = torch.tensor([piece], device=dev)
            pos = torch.arange(s0, s0 + len(piece), dtype=torch.int32,
                               device=dev)[None]
            lg, _ = m.prefill_paged(params, t, pos, tbl, cache,
                                    rows=torch.zeros(1, dtype=torch.int64,
                                                     device=dev),
                                    last_only=True)
        return lg[0, -1].float()

    ops.reset_launches()
    nb = 64
    a = system + a_user
    b = system + b_user
    shared = sys_len // bs
    a_tbl = list(range(-(-len(a) // bs)))
    b_tbl = a_tbl[:shared] + list(range(len(a_tbl),
                                        len(a_tbl) + -(-len(b) // bs)
                                        - shared))
    cache = m.init_paged_cache(nb, bs, n_slots=1)
    prefill(cache, a_tbl, a, 0)
    got = prefill(cache, b_tbl, b, sys_len)
    launches = {k: n for k, n in ops.LAUNCHES.items() if n}
    fresh = m.init_paged_cache(nb, bs, n_slots=1)
    want = prefill(fresh, list(range(-(-len(b) // bs))), b, 0)
    rel = float((got - want).abs().max() / want.abs().max())
    out = dict(layers=2, d_model=cfg.d_model, system_tokens=sys_len,
               suffix_tokens=ub, shared_blocks=shared, rel_max_err=rel,
               tol=5e-2, argmax_equal=bool(got.argmax() == want.argmax()),
               finite=bool(torch.isfinite(got).all()), launches=launches)
    emit("prefix_reference", **out)
    if rel > 5e-2 or not out["finite"] \
            or not launches.get("paged_flash_attention"):
        raise AssertionError(f"prefix_reference: the shared-prefix suffix "
                             f"prefill differs from the whole prefill: "
                             f"{out}")
    del m, params, cache, fresh
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fill_cache(eng, seed: int) -> None:
    """Random K/V, positions, state and cross K/V wherever a request could
    look (the paged spare block's positions stay empty, the sentinel slot
    zero)."""
    from repro_torch.models.backbone import CROSS_KEYS, STATE_KEYS

    g = torch.Generator(device=eng.device).manual_seed(seed)
    for k, v in eng.cache.items():
        if k == "pos":
            v.copy_(torch.randint(-1, eng.max_context, v.shape, generator=g,
                                  device=eng.device, dtype=v.dtype))
            if eng.paged:
                v[-1] = -1
        else:
            v.normal_(generator=g)
            if eng.paged and k in STATE_KEYS + CROSS_KEYS:
                v[:, eng.n_slots] = 0


def run_synced(eng, arch: str) -> dict:
    """The arch's prompts served again on its served engine (warm: its
    steps built and captured by the serve run), every interval under
    `torch.cuda.set_sync_debug_mode("error")`, in which any CUDA call that
    synchronises raises. A tail chunk captured at first use synchronises
    the device by design (`torch.cuda.graph` does before it captures), so
    the mode is off for the capture alone, and an interval that captured
    is counted apart from the covered ones."""
    graphs = eng.graphs
    capture = graphs.capture
    captured = []

    def capture_unchecked(st):
        torch.cuda.set_sync_debug_mode(0)
        try:
            capture(st)
        finally:
            torch.cuda.set_sync_debug_mode("error")
        captured.append(list(st.key))

    # the control: the mode is armed, and a deliberate sync raises
    probe = torch.ones(1, device=eng.device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        probe.item()
        armed = False
    except RuntimeError:
        armed = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not armed:
        raise AssertionError("the sync debug mode let .item() pass")
    handles = [eng.submit(p) for p in serve_prompts(arch)]
    covered, capturing = 0, []
    graphs.capture = capture_unchecked
    t0 = time.perf_counter()
    try:
        while True:
            n = len(captured)
            torch.cuda.set_sync_debug_mode("error")
            try:
                busy = eng.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if not busy:
                break
            if len(captured) == n:
                covered += 1
            else:
                capturing.append(covered + len(capturing))
    finally:
        del graphs.capture
    torch.cuda.synchronize()
    out = dict(armed=armed, intervals=covered + len(capturing),
               covered=covered,
               capturing_intervals=capturing, captured_keys=captured,
               finished=sum(r.finish_time >= 0 for r in handles),
               requests=len(handles), seconds=time.perf_counter() - t0)
    if out["finished"] != len(handles) or not covered:
        raise AssertionError(f"synced run of {arch}: {out}")
    return out


def run_audit_engine(eng, arch: str, layout: str, audit) -> float:
    """The graph audit of a served engine's steps (full width): every step
    it holds traced once eagerly, each decode bucket run twice through
    `Engine._step`. Returns the seconds it took."""
    from repro_torch.analysis.graph_audit import config_path

    t0 = time.perf_counter()
    audit.engine(eng, f"{arch} {layout} full width", config_path(arch))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def run_audit(dev, full, full_s: float, synced: dict) -> dict:
    """The audit phase: the port's AST rules over this checkout with the
    port's allowlist, the graph audit of every registry arch at reduced
    width on the card in bf16 (`graph_audit.card_config`), and the figures
    of the full-width audit (`full`, `run_audit_engine`) and of the synced
    serve run (`run_synced`). Any finding or allowlist problem fails."""
    from repro_torch.analysis import ALLOWLIST, Tree, run
    from repro_torch.analysis.graph_audit import (GraphAudit, OpTrace,
                                                  audit_trace)
    from repro_torch.config.registry import list_archs

    t0 = time.perf_counter()
    lint = run(Tree(root=ROOT), allows=ALLOWLIST)
    lint_s = time.perf_counter() - t0
    # the controls: on the card the detector flags a device-to-host copy
    # and a read of a device scalar
    t0 = time.perf_counter()
    x = torch.ones(2, device=dev)
    controls = {}
    for name, fn in (("cpu", lambda: x.cpu()),
                     ("item", lambda: x[0].item())):
        with OpTrace() as tr:
            fn()
        controls[name] = [str(f) for f in audit_trace(tr, name, "control")]
    if not all(controls.values()):
        raise AssertionError(f"audit: a control went unflagged: {controls}")
    reduced = GraphAudit(dev)
    for arch in list_archs():
        reduced.arch(arch)
        gc.collect()
    torch.cuda.synchronize()
    reduced_s = time.perf_counter() - t0
    found = lint.findings + reduced.findings + full.findings
    per_rule = {k: sum(f.rule == k for f in lint.findings)
                for k in lint.per_rule}
    per_rule["graph-audit"] = len(reduced.findings) + len(full.findings)
    fields = dict(
        findings=per_rule, allowlisted=lint.per_rule,
        allowlist_problems=[str(f) for f in lint.problems],
        messages=[str(f) for f in found], checked_files=lint.checked_files,
        reduced=reduced.totals(), full_width={AUDITED: full.totals()},
        captures_vs_keys={"reduced": [reduced.captures, reduced.keys],
                          AUDITED: [full.captures, full.keys]},
        synced=synced, controls=controls,
        seconds=lint_s + reduced_s + full_s + synced["seconds"],
        seconds_by_part=dict(lint=lint_s, reduced=reduced_s,
                             full_width=full_s, synced=synced["seconds"]))
    emit("audit", **fields)
    if found or lint.problems:
        raise AssertionError(f"audit: {len(found)} finding(s), "
                             f"{len(lint.problems)} allowlist problem(s)")
    if reduced.captures != reduced.keys or full.captures != full.keys:
        raise AssertionError(f"audit: captures differ from distinct step "
                             f"keys: {fields['captures_vs_keys']}")
    return fields


def run_graph_check(eng, name: str):
    """Replay against eager run of the same step, bit for bit, from the
    same cache and inputs: decode at the largest bucket (8, or the arch's
    cut b_max), a lane's full chunk, on the mixed path the mixed step of
    that bucket with every lane's full chunk and, for a family with
    extras, a lane's full first chunk with random extras (the encoder and
    the cross K/V write), on random cache contents and inputs (distinct
    blocks and state slots).
    The cache's two copies (the start, the eager run's result) are kept on
    the card, or in host memory where they do not fit beside the weights
    (qwen1.5-32b)."""
    import numpy as np

    rng = np.random.RandomState(0)
    cache_bytes = sum(nbytes(v) for v in eng.cache.values())
    keep = eng.device if 2 * cache_bytes < 0.8 * torch.cuda.mem_get_info()[0] \
        else torch.device("cpu")
    lane = ("chunk", 1, eng.prefill_chunk, -1 if eng.paged else eng.max_slots)
    keys = [("decode", max(eng.buckets)), lane]
    if eng.mixed:
        keys.append(("mixed", max(eng.buckets), eng.n_lanes))
    if eng.enc_len:
        keys.append(("xchunk",) + lane[1:])
    checks = []
    for key in keys:
        st = eng.graphs.steps[key]
        fill_cache(eng, seed=len(checks))
        per = eng.max_blocks
        if key[0] == "mixed":
            # one row of tokens: the bucket's decode tokens, then a full
            # chunk a lane, each row on blocks of its own (as many as the
            # pool holds for every row; the rest of its table unallocated)
            C = eng.prefill_chunk
            rows, T = key[1] + key[2], C
            per = min(per, eng.mem.num_blocks // rows)
            starts = rng.randint(T, per * eng.serve.block_size - T,
                                 size=rows)
            pos = np.concatenate([starts[:key[1]], (
                starts[key[1]:, None] + np.arange(C)).ravel()])
            host = {"tokens": rng.randint(0, eng.cfg.vocab_size,
                                          (1, pos.size)),
                    "positions": pos[None]}
        else:
            rows, T = st.inputs["tokens"].shape
            starts = rng.randint(T, eng.max_context - 2 * T, size=rows)
            host = {"tokens": rng.randint(0, eng.cfg.vocab_size, (rows, T)),
                    "positions": starts[:, None] + np.arange(T)}
        if eng.paged:
            host["block_table"] = np.full((rows, eng.max_blocks), -1)
            host["block_table"][:, :per] = rng.permutation(
                eng.mem.num_blocks)[:rows * per].reshape(rows, per)
            if "slots" in st.inputs:
                host["slots"] = rng.permutation(eng.n_slots)[:rows]
        for k, v in host.items():
            eng._stage(st, k, v.astype(np.int64))
        if "extras" in st.inputs:
            eng._stage(st, "extras", rng.randn(*st.inputs["extras"].shape))
        start = {k: v.to(keep, copy=True) for k, v in eng.cache.items()}
        want = st.run(eager=True).clone()
        want_cache = {k: v.to(keep, copy=True) for k, v in eng.cache.items()}
        for k, v in start.items():
            eng.cache[k].copy_(v)
        del start
        got = st.run().clone()
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        cache_same = all(bool(torch.equal(v.to(keep), want_cache[k]))
                         for k, v in eng.cache.items())
        del want_cache
        launch_us, device_ms = replay_times(st)
        checks.append(dict(key=list(key), logits_bit_equal=same,
                           cache_bit_equal=cache_same,
                           finite=bool(torch.isfinite(got).all()),
                           max_abs_diff=float((got - want).abs().max()),
                           replay_launch_us=launch_us,
                           replay_device_ms=device_ms))
    emit(f"graphs_{name}", checks=checks, cache_copies_on=keep.type,
         **eng.graphs.stats())
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
        serve_args(arch) + (["--paged"] if paged else [])
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


def _swap_spans(path: Path):
    """Each `swap_out` / `swap_in` annotation of a chrome trace: the CUDA
    runtime calls inside it, the blocking ones, its pageable copies, and
    the device time of the work those calls launched (gathers, scatters,
    copies), with the kinds of its copies."""
    ev = json.loads(path.read_text())["traceEvents"]
    out = []
    for a in (e for e in ev if e.get("cat") == "user_annotation"
              and e.get("name") in ("swap_out", "swap_in")):
        t0, t1 = a["ts"], a["ts"] + a["dur"]
        rt = [e for e in ev if e.get("cat") in ("cuda_runtime",
                                                "cuda_driver")
              and t0 <= e.get("ts", -1) <= t1]
        corr = {e["args"]["correlation"] for e in rt
                if "correlation" in e.get("args", {})}
        dev = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy",
                                                 "gpu_memset")
               and e.get("args", {}).get("correlation") in corr]
        names = [e["name"] for e in rt]
        out.append(dict(
            name=a["name"], host_us=a["dur"], runtime_calls=len(names),
            blocking=[n for n in names if n in SYNC_CALLS],
            pageable_copies=sum(1 for e in dev if "Pageable" in e["name"]),
            copies=sorted({e["name"] for e in dev
                           if e.get("cat") == "gpu_memcpy"}),
            device_us=sum(e.get("dur", 0) for e in dev),
            device_events=len(dev)))
    return out


def run_profile_swap(eng, log: dict, prompts):
    """The depth-0 swap run's first swap-out and first swap-in intervals
    under `torch.profiler`, on that run's engine serving its prompts again
    (every tail chunk is captured by now, and the static policy repeats
    the interval sequence): the swap calls, annotated from outside, make
    no blocking CUDA call and no pageable copy, and the traced intervals'
    one blocking call is the retirement's event wait. Prints the device
    time of the swap's gathers, scatters and copies per swapped block."""
    from torch.profiler import ProfilerAction, ProfilerActivity

    del eng._swap_out, eng._swap_in_next        # the round-trip watchers
    swap_out, swap_in = eng._swap_out, eng._swap_in_next
    marks = []

    def out_ann(slot, r):
        marks.append(("out", len(eng.blocks.table(r.rid)),
                      len(eng.step_host_trace)))
        with torch.profiler.record_function("swap_out"):
            return swap_out(slot, r)

    def in_ann():
        r = eng.swapped[0]
        with torch.profiler.record_function("swap_in"):
            ok = swap_in()
        if ok:
            marks.append(("in", len(eng.blocks.table(r.rid)),
                          len(eng.step_host_trace)))
        return ok

    eng._swap_out, eng._swap_in_next = out_ann, in_ann
    base = len(eng.step_host_trace)
    targets = {base + log["out_at"][0], base + log["in_at"][0]}

    def sched(step):
        if base + step in targets:
            return ProfilerAction.RECORD_AND_SAVE
        if base + step + 1 in targets:
            return ProfilerAction.WARMUP
        return ProfilerAction.NONE

    OUT_DIR.mkdir(exist_ok=True)
    paths = []

    def save(prof):
        paths.append(OUT_DIR / f"trace_{TIER_ARCH}_swap_{len(paths)}.json")
        prof.export_chrome_trace(str(paths[-1]))

    n0 = eng.total_finished
    for p in prompts:
        eng.submit(p)
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=sched, on_trace_ready=save) as prof:
        while True:
            with torch.profiler.record_function("interval"):
                more = eng.step()
            prof.step()
            if not more:
                break
    torch.cuda.synchronize()
    traced = [dict(trace=str(pth.relative_to(ROOT)), **trace_interval(pth),
                   swaps=_swap_spans(pth)) for pth in paths]
    swaps = [w for t in traced for w in t["swaps"]]
    hit = {(k, i) for k, _, i in marks if i in targets}
    blocks = {k: b for k, b, i in marks if i in targets}
    per_block = {w["name"]: w["device_us"] / max(blocks.get(
        w["name"][5:], 1), 1) for w in swaps}
    out = dict(arch=TIER_ARCH, overlap_depth=eng.overlap_depth,
               targets=sorted(t - base for t in targets),
               marks=[(k, b, i - base) for k, b, i in marks],
               finished=eng.total_finished - n0, intervals=traced,
               device_us_per_block=per_block)
    emit("profile_swap", **out)
    bad = [w for w in swaps if w["blocking"] or w["pageable_copies"]] \
        + [t for t in traced if t["syncs_before_readback"]
           or t["pageable_copies"] or t["readback"] != READBACK]
    if bad or {k for k, _ in hit} != {"out", "in"} \
            or {w["name"] for w in swaps} != {"swap_out", "swap_in"} \
            or eng.total_finished - n0 != len(prompts):
        raise AssertionError(f"profile_swap: a swap call blocks or copies "
                             f"pageable memory, the traced intervals did "
                             f"not swap, or an interval blocks before its "
                             f"event wait: {bad or out}")
    return out


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
    start = last = time.perf_counter()
    phase_s = {}

    def lap(name):
        """The seconds since the previous lap, under `name`."""
        nonlocal last
        now = time.perf_counter()
        phase_s[name] = now - last
        last = now

    t0 = time.perf_counter()
    logs = _build.build_all()
    ptxas = ptxas_table(logs)
    hmma = tf32_hmma_count("ssd_scan")
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas,
         ssd_tf32_hmma=hmma)
    spills = [r for r in ptxas if (r["kernel"].startswith(("mma_", "wg_"))
                                   or r["lib"] in ("ssd_scan", "rglru_scan"))
              and (r["spill_stores"] or r["spill_loads"] or r["stack"])]
    for kind in ("mma_attention_kernel", "wg_attention_kernel"):
        built = [r["kernel"] for r in ptxas if r["kernel"].startswith(kind)]
        if not any(k.endswith(", true>") for k in built) \
                or not any(k.endswith(", false>") for k in built):
            raise AssertionError(f"{kind}: the paged or the contiguous "
                                 f"instantiations were not built: {built}")
    if spills:
        raise AssertionError(f"tensor-core attention, SSD or RG-LRU kernels "
                             f"spill or have a stack frame: {spills}")
    if hmma == 0:
        raise AssertionError("the SSD kernel has no TF32 tensor-core "
                             "instruction in its SASS")

    lap("build")
    kres = run_kernels(dev)
    split_rows = run_split_rows(dev)
    tp_slices, tp_rows = run_tp_kernels(dev)
    kres += tp_rows
    lap("kernels")
    refs = [run_reference(dev, arch) for arch in REFERENCE]
    cross_refs = [run_cross_reference(dev, arch) for arch in CROSS_REFERENCE]
    sliding_ref = run_sliding_reference(dev)
    prefix_ref = run_prefix_reference(dev)
    lap("references")
    serves, runs, launches, graphs, served = {}, {}, {}, {}, {}
    from repro_torch.analysis.graph_audit import GraphAudit
    full_audit, full_audit_s, synced = GraphAudit(dev), 0.0, None

    def tokens(key):
        return [r.output_tokens for r in served[key][1]]

    def agreement(arch):
        """How far the two layouts' greedy tokens agree: bf16 logits of
        random weights are flat, so a near tie flips between the layouts'
        kernels and the request's tokens part from there."""
        pairs = list(zip(tokens((arch, "contiguous")),
                         tokens((arch, "paged"))))
        return dict(requests_with_equal_tokens=sum(a == b for a, b in pairs),
                    equal_leading_tokens=[next(
                        (i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                        len(a)) for a, b in pairs], requests=len(pairs))

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
            if arch == AUDITED:
                if not paged:
                    synced = run_synced(eng, arch)
                full_audit_s += run_audit_engine(eng, arch, layout,
                                                 full_audit)
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
    lap("serve")
    audit = run_audit(dev, full_audit, full_audit_s, synced)
    lap("audit")
    layout_tokens = {arch: agreement(arch) for arch in FAMILIES}
    emit("layout_tokens", **layout_tokens)
    # the sliding variant: the contiguous ring wraps, the paged pool masks
    # by window; both layouts serve the same counters. In bf16 their tokens
    # part where a near tie flips, because the ring sums its keys in
    # another order than the pool's walk (rotated, and split by the plan of
    # 271 slots, not 1024; the dense archs' layouts sum in one order and
    # agree bit for bit, `layout_tokens`). In fp32 they must be equal.
    arch, window = SLIDING
    from repro_torch.configs.mistral_nemo_12b import sliding
    swa = sliding(window=window)
    for dtype in (None, torch.float32):
        key = swa.name + ("_fp32" if dtype else "")
        layouts = {}
        for paged in (False, True):
            layout = "paged" if paged else "contiguous"
            fields, eng, reqs = run_serve(arch, paged, cfg=swa, dtype=dtype)
            if not paged:
                ring = eng.cache["k"].shape[2]
                reach = max(r.prompt_len + len(r.output_tokens)
                            for r in reqs)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            served[key, layout] = (fields, reqs)
            layouts[layout] = fields["summary"]
            runs[f"{key}_{layout}"] = fields
            for k, n in fields["launches"].items():
                launches[k] = launches.get(k, 0) + n
        s_c, s_p = layouts["contiguous"], layouts["paged"]
        diff = {k: (s_c[k], s_p[k]) for k in STRUCTURAL if s_c[k] != s_p[k]}
        layout_tokens[key] = agreement(key)
        emit(f"sliding_{key}", window=window, ring_slots=ring,
             longest_context=reach, structural_diff=diff,
             **layout_tokens[key], control={arch: layout_tokens[arch]})
        if not ring < reach:
            raise AssertionError(f"{key}: the ring of {ring} slots never "
                                 f"wrapped (longest context {reach})")
        if diff:
            raise AssertionError(f"{key}: structural counters differ "
                                 f"between cache layouts: {diff}")
        agree = layout_tokens[key]
        if dtype and agree["requests_with_equal_tokens"] != agree["requests"]:
            raise AssertionError(f"{key}: the layouts' tokens differ: "
                                 f"{agree}")
        serves[key] = layouts
    lap("sliding")
    if any((n > 0) == (k in OFF_PATH) for k, n in launches.items()
           if k not in TP_PATH):
        raise AssertionError(f"a path kernel never launched, or an "
                             f"off-path one did: {launches}")
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
    lap("eager_overlap")
    twins = {f"{arch}_{layout}": run_twin(arch, layout, {
        depth: served[key] for depth, key in (
            (0, (arch, layout)), (OVERLAP_DEPTH, (arch, layout, OVERLAP_DEPTH)))
        if key in served})
        for arch in TWINNED for layout in ("contiguous", "paged")}
    # the memory tiers (DESIGN §10, §11), their launches on the main path
    tiers, tier_launches, (swap_eng, swap_log, _) = run_tiers()
    for k, n in tier_launches.items():
        launches[k] = launches.get(k, 0) + n
    lap("twins_tiers")
    arch, layout = PROFILED
    profile = run_profile(arch, layout == "paged")
    profile_overlap = run_profile(arch, layout == "paged",
                                  depth=OVERLAP_DEPTH)
    profile_swap = run_profile_swap(swap_eng, swap_log,
                                    serve_prompts(TIER_ARCH))
    del swap_eng, swap_log
    gc.collect()
    torch.cuda.empty_cache()
    lap("profiles")
    # tensor-parallel serving (DESIGN §12): one NCCL rank on graphs, then
    # two gloo ranks on the one card, eager
    tp = dict(nccl=run_tp_nccl(served, graphs, launches),
              gloo=run_tp_gloo(card, launches), slices=tp_slices)
    lap("tp")
    # the layouts the port once refused: split query heads, the cross
    # fallback, the sequence-sharded decode (its kernels' launches)
    tp["layouts"] = run_tp_layouts(card, launches)
    if not all(launches.get(k) for k in TP_PATH):
        raise AssertionError(f"a kernel of the mesh path never launched in "
                             f"the tp runs: {launches}")
    lap("tp_layouts")
    # training, once every serving engine is released
    train_runs = {"reduced": run_train_reduced(dev)}
    for arch in TRAIN_FULL:
        train_runs[arch] = run_train_full(dev, card, arch)
    lap("train")
    dry = run_dryrun(dev, card, train_runs)
    lap("dryrun")
    # the script's seconds from its build on (the imports before it and
    # the summary after it take under a second)
    timing = dict(phases=phase_s, seconds=time.perf_counter() - start)
    emit("timing", **timing)

    summary = []
    for name, (route, source, replaces, case) in KERNELS.items():
        rows = [r for r in kres if r["name"] == name]
        main_row = next(r for r in rows if r["case"] == case)
        # an entry's count holds every call; its wgmma calls are counted
        # apart too, so the mma.sync kernel's launches are the rest
        n = launches.get(name, 0) - launches.get(f"{name}_wgmma", 0)
        summary.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=n,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], case=main_row["case"],
            **{k: main_row[k] for k in ("host_us", "library_host_us",
                                        "plain_host_us", "chain_ms",
                                        "chain_host_us") if k in main_row},
            **next(({"graph_ms": r["graph_ms"], "stream_ms": r["stream_ms"],
                     "graph_case": r["case"]} for r in sorted(
                         rows, key=lambda r: r["case"] != case)
                    if "graph_ms" in r), {})))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "ptxas": ptxas, "kernels": kres, "summary": summary,
         "reference": refs, "cross_reference": cross_refs, "serve": runs,
         "launches": launches,
         "graphs": graphs, "profile": profile,
         "profile_overlap": profile_overlap, "serve_overlap": overlap,
         "twin": twins, "tiers": tiers, "prefix_reference": prefix_ref,
         "sliding_reference": sliding_ref, "layout_tokens": layout_tokens,
         "profile_swap": profile_swap, "audit": audit, "train": train_runs,
         "tp": tp, "split_rows": split_rows, "timing": timing,
         "dryrun": dry},
        indent=1))
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
