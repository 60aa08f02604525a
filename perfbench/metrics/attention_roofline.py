"""The least time the traced slice's attention work takes at the card's
peaks, over the profiler's time of the attention kernels, in %.

The work is counted from the requests served, not from the launches:
each decode row's visible K/V read once; each prompt's K/V positions read
once (a shared prefix once a request); every query's q read and output
written once; q·k and p·v for each query against each visible key. Its
least time is the larger of those bytes at 3.35 TB/s and those operations
at 989 TFLOP/s. The kernels timed are those whose names hold one of
KERNELS (the port's flash-decode, flash-attention, long-row and split
combine kernels)."""
from perfbench.peaks import BF16_FLOPS, HBM_BPS

LAYER = "kernels"
UNIT = "%"
MOVES = "tbt_mean_ms"
BETTER = "higher"
SOURCE = "device_trace"

KERNELS = ("mma_attention_kernel", "mma_combine_kernel",
           "wg_attention_kernel", "flash_kernel", "decode_kernel")


def read(run):
    if run.trace is None:
        return None
    t = sum(s for n, s in run.trace.device_ops
            if any(k in n for k in KERNELS))
    steps = [s for s in run.steps if s.traced]
    if t <= 0 or not steps:
        return None
    fam, c = run.family, run.config
    nbytes = sum((s.decode_keys + s.prefill_kv_reads)
                 * fam.kv_bytes_per_position(c)
                 + (s.decode_rows + s.prefill_tokens)
                 * fam.qo_bytes_per_query(c) for s in steps)
    ops = sum(s.decode_keys + s.prefill_keys
              for s in steps) * fam.attention_flops_per_key(c)
    return 100.0 * max(nbytes / HBM_BPS, ops / BF16_FLOPS) / t
