"""Per-rank kernel launches of tensor-parallel serving against the whole
launch (DESIGN §12), on one GPU.

    PYTHONPATH=src python -m repro_torch.bench.tp_slices

At a model axis of m, rank r attends with query heads [r·H/m, (r+1)·H/m)
on kv-heads [r·KV/m, (r+1)·KV/m) (heads are kv-major). Each case builds
a whole attention launch's inputs, launches the kernel on them and on
each rank's slice of the heads, and compares the rank's output with the
same heads of the whole output: granite-3-8b's decode, paged decode and
chunks (32 heads on 8 kv-heads of 128), and the non-causal launches of
the enc-dec and VLM families (`causal=False`): seamless-m4t-medium's
encoder over 1024 frames (16 heads of 64, G 1; a rank 8) and
llama-3.2-vision-90b's decode-step cross read over 1601 patches (64 on 8
heads of 128; a rank 32 on 4), contiguous and paged (each request's
cross row one block of 1601 slots, tables = rows.view(B, 1)), and
recurrentgemma-9b's local attention under the head_dim fallback: a rank's
8 of 16 query heads on the single kv-head of 256, gathered whole (the
rank's K/V inputs are the whole launch's), decode B 8 over its 2048-key
window, contiguous and paged, and Tq 16 chunks. The fp32 attention
kernels (CUDA cores) never split the key axis: bit for bit. The bf16
tensor-core kernels split it by the grid's size (`split.num_splits`, which
depends on KV and the packed query rows): where the whole launch and a
rank's get the same count the sums run in the same order, bit for bit;
where not, within ATOL + RTOL · |whole|.

Kernels 5 and 6 per rank: mamba2-2.7b's `ssd_intra` on 40 of its 80 heads
(B and C whole: every head reads them), fp32, and RecurrentGemma's
`rglru_gated_scan` on 2048 of its 4096 channels (B 8 T 1 and two lanes of
a 16-token chunk, bf16 and fp32), are held bit for bit: each head or
channel is computed on its own, so a rank's slice runs the whole launch's
operations in the same order. The hybrid's attention, whose rank packs 8
query rows on its kv-head where the whole launch packs 16, is held within
ATOL + RTOL · |whole| in bf16 and FP32_TOL · max|whole| in fp32 (its
launch shape, and so its order of operations, may differ from the whole
launch's; whether bit for bit is printed).

Prints the card's name and power limit, then one JSON object a case.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.bench.rglru_sweep import gated_inputs
from repro_torch.kernels import ops, split

#: granite-3-8b's attention, and its model axis in the chip smoke run
H, KV, HD, M = 32, 8, 128, 2
#: the non-causal cases: seamless-m4t-medium's encoder (heads, kv-heads,
#: head_dim, frames) and llama-3.2-vision-90b's cross read (heads,
#: kv-heads, head_dim, patches, decode rows)
ENCODER = (16, 16, 64, 1024)
CROSS = (64, 8, 128, 1601, 8)
#: recurrentgemma-9b's local attention (heads, kv-heads, head_dim,
#: window), mamba2-2.7b's SSD (heads, P, N, the serving chunk Q) and the
#: RG-LRU width
HYBRID = (16, 1, 256, 2048)
SSD = (80, 64, 128, 16)
LRU = 4096
#: bf16 per-rank output against the same heads of the whole launch, where
#: the two launches split the key axis differently (and kernels 5 and 6 in
#: bf16); kernels 5 and 6 in fp32, a fraction of max|whole|
ATOL = RTOL = 2e-2
FP32_TOL = 1e-4
#: the pool of the paged cases: blocks of 16 tokens, 64 per table
BS, MB = 16, 64
#: the granite TP-2 serving shapes, and beside each one whose split counts
#: agree (a full row at B 32; a Tq 500 chunk)
DECODE_LENS = {"B=8 fill=33-1024": [33, 100, 160, 240, 384, 512, 777, 1024],
               "B=32 S=1024": [1024] * 32}
CHUNKS = (16, 500)


@dataclasses.dataclass
class Case:
    name: str                       # the ops entry
    label: str
    fn: Callable
    args: Tuple                     # the whole launch's inputs
    heads: Tuple                    # each input's head axis (None: none)
    out_axis: int                   # the output's head axis
    rows: int                       # Tq · G packed query rows
    key_slots: int                  # keys a row walks (S, or MB · bs)
    batch: int
    visible: int                    # (query, key) pairs some mask admits
    read_bytes: int                 # K, V and position bytes a walk reads
    h: int = H                      # the whole launch's heads,
    kv: int = KV                    # kv-heads
    hd: int = HD                    # and head_dim
    causal: bool = True
    kv_split: bool = True           # the rank's K/V inputs are its kv-heads
    #: for kernels 5 and 6: the rank launch's bytes and operations, and
    #: the peak its operations run at (None: attention's, from the shapes)
    nbytes: int = 0
    nops: int = 0
    peak: str = "bf16"

    @property
    def attention(self) -> bool:
        return "attention" in self.name

    def rank_args(self, r: int, m: int = M):
        return tuple(a if ax is None else
                     a.narrow(ax, r * a.shape[ax] // m,
                              a.shape[ax] // m).contiguous()
                     for a, ax in zip(self.args, self.heads))

    def _rows(self, m: int) -> int:
        return self.rows if self.kv_split else self.rows // m

    def kernel(self, m: int = 1) -> str:
        """The bf16 kernel a launch on 1/m of the query heads takes: the
        prefill entries' route ("mma" or "wgmma"), "mma" for decode."""
        if "flash" not in self.name:
            return "mma"
        bs = self.args[1].shape[1] if self.name.startswith("paged") else None
        return split.route(self.args[0].dtype, self.hd, self._rows(m),
                           self.key_slots, bs)

    def splits(self, m: int = 1) -> int:
        """The bf16 attention kernels' key-axis split count of a launch on
        1/m of the query heads (m = 1: the whole launch); 1 in fp32 and
        for kernels 5 and 6."""
        if self.args[0].dtype != torch.bfloat16 or not self.attention:
            return 1
        kv = self.kv // m if self.kv_split else self.kv
        return split.launch_splits(self.kernel(m), self.batch, kv,
                                   self._rows(m), self.key_slots, self.hd,
                                   split.sm_count(self.args[0].device.index))

    def rank_bytes(self, m: int = M) -> int:
        """Bytes one rank's launch must move: its q and output, its share
        of the K/V reads (all of them where its K/V are whole), the
        positions (and tables) whole."""
        if self.nbytes:
            return self.nbytes
        q = self.args[0]
        qo = 2 * q.numel() * q.element_size() // m
        small = sum(a.numel() * a.element_size()
                    for a, ax in zip(self.args, self.heads)
                    if ax is None and a.dtype in (torch.int32, torch.int64))
        return qo + (self.read_bytes // m if self.kv_split
                     else self.read_bytes) + small

    def rank_ops(self, m: int = M) -> int:
        return self.nops or 4 * self.hd * (self.h // m) * self.visible


def _pools(lens: Sequence[int], dtype, g, dev, kv: int = KV, hd: int = HD,
           mb: int = MB):
    """Pools of exactly the blocks the rows need, with shuffled ids and
    -1 table tails: row b holds positions [0, lens[b])."""
    need = [-(-n // BS) for n in lens]
    NB = sum(need) + 1
    kp = torch.randn((NB, BS, kv, hd), generator=g, device=dev).to(dtype)
    vp = torch.randn((NB, BS, kv, hd), generator=g, device=dev).to(dtype)
    perm = torch.randperm(NB, generator=g, device=dev)
    tables = torch.full((len(lens), mb), -1, dtype=torch.int32, device=dev)
    kpos = torch.full((NB, BS), -1, dtype=torch.int32, device=dev)
    used = 0
    for b, (n, nb) in enumerate(zip(lens, need)):
        ids = perm[used:used + nb]
        used += nb
        tables[b, :nb] = ids.to(torch.int32)
        pos = torch.arange(nb * BS, dtype=torch.int32, device=dev)
        kpos[ids] = torch.where(pos < n, pos, -1).reshape(nb, BS)
    read = sum(need) * BS * (kv * hd * 2 * kp.element_size() + 4)
    return kp, vp, kpos, tables, read


def cases(dev, dtype) -> List[Case]:
    """The decode, paged decode and prefill-chunk cases in `dtype`."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    out = []
    G, esz = H // KV, torch.empty((), dtype=dtype).element_size()
    for label, lens in DECODE_LENS.items():
        B, S = len(lens), 1024
        n = torch.tensor(lens, dtype=torch.int32, device=dev)
        ar = torch.arange(S, dtype=torch.int32, device=dev)
        q, k, v = rn(B, H, HD), rn(B, S, KV, HD), rn(B, S, KV, HD)
        kp = torch.where(ar[None] < n[:, None], ar[None], -1)
        out.append(Case("decode_attention", label, ops.decode_attention,
                        (q, k, v, n - 1, kp), (1, 2, 2, None, None), 1, G,
                        S, B, sum(lens),
                        sum(lens) * KV * HD * 2 * esz + B * S * 4))
        kpool, vpool, kpos, tables, read = _pools(lens, dtype, g, dev)
        q = rn(B, H, HD)
        out.append(Case("paged_decode_attention", label,
                        ops.paged_decode_attention,
                        (q, kpool, vpool, n - 1, kpos, tables),
                        (1, 2, 2, None, None, None), 1, G, MB * BS, B,
                        sum(lens), read))
    for Tq in CHUNKS:
        end, Tk = max(496, Tq), 1024
        qp = torch.arange(end - Tq, end, dtype=torch.int32, device=dev)[None]
        ar = torch.arange(Tk, dtype=torch.int32, device=dev)
        kp = torch.where(ar < end, ar, -1)[None]
        vis = sum(p + 1 for p in range(end - Tq, end))
        q, k, v = rn(1, Tq, H, HD), rn(1, Tk, KV, HD), rn(1, Tk, KV, HD)
        label = f"Tq={Tq}"
        out.append(Case("flash_attention", label, ops.flash_attention,
                        (q, k, v, qp, kp), (2, 2, 2, None, None), 2,
                        Tq * G, Tk, 1, vis,
                        end * (KV * HD * 2 * esz + 4)))
        kpool, vpool, kpos, tables, read = _pools([end], dtype, g, dev)
        q = rn(1, Tq, H, HD)
        out.append(Case("paged_flash_attention", label,
                        ops.paged_flash_attention,
                        (q, kpool, vpool, qp, kpos, tables),
                        (2, 2, 2, None, None, None), 2, Tq * G, MB * BS, 1,
                        vis, read))
    return out + noncausal_cases(rn, dev, esz) \
        + hybrid_cases(rn, dev, esz, g, dtype) + state_cases(g, dev, dtype)


def hybrid_cases(rn, dev, esz, g, dtype) -> List[Case]:
    """recurrentgemma-9b's local attention under the head_dim fallback: a
    rank's 8 of 16 query heads on the kv-head gathered whole (its K/V
    inputs the whole launch's): decode B 8 at the end of a full
    2048-key window, contiguous and paged, and Tq 16 chunks there."""
    h, kv, hd, W = HYBRID
    G, B, mb = h // kv, 8, W // BS + 1

    def win(fn):
        return lambda *a: fn(*a, window=W)

    out = []
    n = torch.full((B,), W, dtype=torch.int32, device=dev)
    kp = torch.arange(W, dtype=torch.int32, device=dev).repeat(B, 1)
    read = B * W * (kv * hd * 2 * esz + 4)
    label = f"hybrid B={B} S={W} G={G}"
    out.append(Case("decode_attention", label, win(ops.decode_attention),
                    (rn(B, h, hd), rn(B, W, kv, hd), rn(B, W, kv, hd),
                     n - 1, kp), (1, None, None, None, None), 1, G, W, B,
                    B * W, read, h, kv, hd, kv_split=False))
    kpool, vpool, kpos, tables, read = _pools([W] * B, dtype, g, dev, kv,
                                              hd, mb)
    out.append(Case("paged_decode_attention", f"hybrid B={B} blocks="
                    f"{W // BS} G={G}", win(ops.paged_decode_attention),
                    (rn(B, h, hd), kpool, vpool, n - 1, kpos, tables),
                    (1, None, None, None, None, None), 1, G, mb * BS, B,
                    B * W, read, h, kv, hd, kv_split=False))
    Tq = 16
    qp = torch.arange(W - Tq, W, dtype=torch.int32, device=dev)[None]
    vis = sum(min(p + 1, W) for p in range(W - Tq, W))
    out.append(Case("flash_attention", f"hybrid Tq={Tq} Tk={W} G={G}",
                    win(ops.flash_attention),
                    (rn(1, Tq, h, hd), rn(1, W, kv, hd), rn(1, W, kv, hd),
                     qp, kp[:1]), (2, None, None, None, None), 2, Tq * G,
                    W, 1, vis, W * (kv * hd * 2 * esz + 4), h, kv, hd,
                    kv_split=False))
    kpool, vpool, kpos, tables, read = _pools([W], dtype, g, dev, kv, hd,
                                              mb)
    out.append(Case("paged_flash_attention", f"hybrid Tq={Tq} blocks="
                    f"{W // BS} G={G}", win(ops.paged_flash_attention),
                    (rn(1, Tq, h, hd), kpool, vpool, qp, kpos, tables),
                    (2, None, None, None, None, None), 2, Tq * G, mb * BS, 1,
                    vis, read, h, kv, hd, kv_split=False))
    return out


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def state_cases(g, dev, dtype, m: int = M) -> List[Case]:
    """Kernels 5 and 6 on a rank's heads or channels: mamba2-2.7b's SSD
    term at the serving chunk (fp32 whatever `dtype`: the kernel's only
    type; once, in the fp32 pass), and the gated RG-LRU recurrence at a
    decode step (B 8 T 1) and two lanes of a chunk (B 2 T 16). The bounds
    are the rank's launch's: each input read once, each output written
    once, the SSD's operations at TF32's peak, the recurrence's at
    fp32's."""
    out = []
    if dtype == torch.float32:
        H, P, N, Q = SSD
        B, nc = 1, 1
        dt = torch.rand((B, nc, Q, H), generator=g, device=dev) * 0.099 \
            + 0.001
        A = -torch.arange(1, H + 1, dtype=torch.float32, device=dev)
        xdt = torch.randn((B, nc, Q, H, P), generator=g, device=dev) \
            * dt[..., None]
        cum_a = torch.cumsum(dt * A, dim=2)
        Br = torch.randn((B, nc, Q, N), generator=g, device=dev)
        Cr = torch.randn((B, nc, Q, N), generator=g, device=dev)
        h = H // m
        tri = Q * (Q + 1) // 2
        out.append(Case(
            "ssd_intra", f"B={B} nc={nc} Q={Q} H={H} P={P} N={N}",
            ops.ssd_intra, (xdt, cum_a, Br, Cr), (3, 3, None, None), (3, 2),
            Q, Q, B, 0, 0, h=H, kv=0, hd=P,
            nbytes=(_nbytes(xdt, cum_a) // m + _nbytes(Br, Cr)
                    + xdt.numel() * 4 // m + B * nc * h * P * N * 4),
            nops=2 * B * nc * (N * tri + h * (P * tri + Q * N * P)),
            peak="tf32"))
    for B, T in ((8, 1), (2, 16)):
        a = gated_inputs(B, T, g, dev, dtype)
        w = LRU // m
        out.append(Case(
            "rglru_gated_scan", f"B={B} T={T} W={LRU} "
            f"{str(dtype).removeprefix('torch.')}", ops.rglru_gated_scan, a,
            (2, 2, 2, 0, 0, 0, 1), (2, 1), T, T, B, 0, 0, h=LRU, kv=0, hd=1,
            nbytes=(_nbytes(*a) + _nbytes(a[0], a[6])) // m,
            nops=15 * B * T * w, peak="fp32"))
    return out


def noncausal_cases(rn, dev, esz) -> List[Case]:
    """The encoder's self-attention (queries and keys at positions
    0..S-1, every key visible) and the VLM's decode-step cross read (all
    at position 0), contiguous and paged, at the whole launch's heads."""
    def nc(fn):
        return lambda *a: fn(*a, causal=False)

    h, kv, hd, S = ENCODER
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    out = [Case("flash_attention", f"encoder Tq=Tk={S} hd={hd} G=1",
                nc(ops.flash_attention),
                (rn(1, S, h, hd), rn(1, S, kv, hd), rn(1, S, kv, hd), pos,
                 pos), (2, 2, 2, None, None), 2, S * (h // kv), S, 1, S * S,
                S * (kv * hd * 2 * esz + 4), h, kv, hd, causal=False)]
    h, kv, hd, S, B = CROSS
    qp = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    kp = torch.zeros((B, S), dtype=torch.int32, device=dev)
    read = B * S * (kv * hd * 2 * esz + 4)
    out.append(Case("flash_attention", f"cross B={B} Tq=1 Tk={S} G=8",
                    nc(ops.flash_attention),
                    (rn(B, 1, h, hd), rn(B, S, kv, hd), rn(B, S, kv, hd), qp,
                     kp), (2, 2, 2, None, None), 2, h // kv, S, B, B * S,
                    read, h, kv, hd, causal=False))
    # the paged read: each request's cross K/V one block of S slots of the
    # per-slot rows (B + 1 of them: the padding sentinel's too)
    rows = torch.randperm(B + 1, device=dev)[:B]
    out.append(Case("paged_flash_attention", f"cross B={B} Tq=1 bs={S} G=8",
                    nc(ops.paged_flash_attention),
                    (rn(B, 1, h, hd), rn(B + 1, S, kv, hd),
                     rn(B + 1, S, kv, hd), qp,
                     torch.zeros((B + 1, S), dtype=torch.int32, device=dev),
                     rows.to(torch.int32).view(B, 1)),
                    (2, 2, 2, None, None, None), 2, h // kv, S, B, B * S,
                    read, h, kv, hd, causal=False))
    return out


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def compare(case: Case, m: int = M) -> Dict[str, object]:
    """Each rank's launch against the same heads (or channels) of the
    whole launch, output by output: whether bit for bit, the largest
    difference, within tolerance (ATOL + RTOL · |whole|; for kernels 5
    and 6 in fp32, FP32_TOL · max|whole|), and the split counts."""
    whole = _tuple(case.fn(*case.args))
    axes = _tuple(case.out_axis)
    fp32 = whole[0].dtype == torch.float32
    bitwise, diff, within = [], 0.0, True
    for r in range(m):
        got = _tuple(case.fn(*case.rank_args(r, m)))
        for g, w, ax in zip(got, whole, axes):
            want = w.narrow(ax, r * w.shape[ax] // m, w.shape[ax] // m)
            bitwise.append(bool(torch.equal(g, want)))
            d = (g.float() - want.float()).abs()
            diff = max(diff, float(d.max()))
            tol = FP32_TOL * float(want.float().abs().max()) if fp32 \
                else ATOL + RTOL * want.float().abs()
            within &= bool((d <= tol).all())
    return dict(name=case.name, case=case.label,
                dtype=str(case.args[0].dtype).removeprefix("torch."),
                splits_whole=case.splits(), splits_rank=case.splits(m),
                bitwise=bitwise, max_abs_diff=diff, within_tol=within,
                exact=case.kv_split or not case.attention)


def verdict(row: Dict[str, object]) -> bool:
    """The rule: an attention launch on the rank's kv-heads (the same
    query rows a kv-head as the whole launch's) bit for bit in fp32 and at
    equal split counts; kernels 5 and 6 bit for bit (each head or channel
    is computed on its own, in the same order whatever the launch's
    width); the hybrid's attention, whose rank packs fewer query rows on
    the kv-head, within tolerance (ATOL + RTOL · |whole| in bf16,
    FP32_TOL · max|whole| in fp32)."""
    exact = row["exact"] and (row["dtype"] == "float32"
                              or row["splits_whole"] == row["splits_rank"])
    return all(row["bitwise"]) if exact else bool(row["within_tol"])


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        for c in cases(torch.device("cuda"), dtype):
            row = compare(c)
            row["ok"] = verdict(row)
            ok &= row["ok"]
            print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
