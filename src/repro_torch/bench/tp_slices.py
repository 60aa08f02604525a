"""Per-rank attention launches of tensor-parallel serving against the whole
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
cross row one block of 1601 slots, tables = rows.view(B, 1)). The
fp32 kernels (CUDA cores) never split the key axis: bit for bit. The bf16
tensor-core kernels split it by the grid's size (`split.num_splits`, which
depends on KV): where the whole launch and a rank's get the same count the
sums run in the same order, bit for bit; where not, within ATOL + RTOL ·
|whole|. Prints the card's name and power limit, then one JSON object a
case.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.kernels import ops, split

#: granite-3-8b's attention, and its model axis in the chip smoke run
H, KV, HD, M = 32, 8, 128, 2
#: the non-causal cases: seamless-m4t-medium's encoder (heads, kv-heads,
#: head_dim, frames) and llama-3.2-vision-90b's cross read (heads,
#: kv-heads, head_dim, patches, decode rows)
ENCODER = (16, 16, 64, 1024)
CROSS = (64, 8, 128, 1601, 8)
#: bf16 per-rank output against the same heads of the whole launch, where
#: the two launches split the key axis differently
ATOL = RTOL = 2e-2
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

    def rank_args(self, r: int, m: int = M):
        return tuple(a if ax is None else
                     a.narrow(ax, r * a.shape[ax] // m,
                              a.shape[ax] // m).contiguous()
                     for a, ax in zip(self.args, self.heads))

    def splits(self, kv: int) -> int:
        """The bf16 kernels' key-axis split count at `kv` kv-heads (1 in
        fp32)."""
        if self.args[0].dtype != torch.bfloat16:
            return 1
        return split.num_splits(
            self.batch, kv, split.row_tiles(self.rows),
            -(-self.key_slots // split.key_tile(self.hd, self.rows)),
            split.sm_count(self.args[0].device.index))

    def rank_bytes(self, m: int = M) -> int:
        """Bytes one rank's launch must move: its q and output, its share
        of the K/V reads, the positions (and tables) whole."""
        q = self.args[0]
        qo = 2 * q.numel() * q.element_size() // m
        small = sum(a.numel() * a.element_size()
                    for a, ax in zip(self.args, self.heads)
                    if ax is None)
        return qo + self.read_bytes // m + small

    def rank_ops(self, m: int = M) -> int:
        return 4 * self.hd * (self.h // m) * self.visible


def _pools(lens: Sequence[int], dtype, g, dev):
    """Pools of exactly the blocks the rows need, with shuffled ids and
    -1 table tails: row b holds positions [0, lens[b])."""
    need = [-(-n // BS) for n in lens]
    NB = sum(need) + 1
    kp = torch.randn((NB, BS, KV, HD), generator=g, device=dev).to(dtype)
    vp = torch.randn((NB, BS, KV, HD), generator=g, device=dev).to(dtype)
    perm = torch.randperm(NB, generator=g, device=dev)
    tables = torch.full((len(lens), MB), -1, dtype=torch.int32, device=dev)
    kpos = torch.full((NB, BS), -1, dtype=torch.int32, device=dev)
    used = 0
    for b, (n, nb) in enumerate(zip(lens, need)):
        ids = perm[used:used + nb]
        used += nb
        tables[b, :nb] = ids.to(torch.int32)
        pos = torch.arange(nb * BS, dtype=torch.int32, device=dev)
        kpos[ids] = torch.where(pos < n, pos, -1).reshape(nb, BS)
    read = sum(need) * BS * (KV * HD * 2 * kp.element_size() + 4)
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
    return out + noncausal_cases(rn, dev, esz)


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


def compare(case: Case, m: int = M) -> Dict[str, object]:
    """Each rank's launch against the same heads of the whole launch:
    whether bit for bit, the largest difference, and the split counts."""
    whole = case.fn(*case.args)
    bitwise, diff, within = [], 0.0, True
    for r in range(m):
        got = case.fn(*case.rank_args(r, m))
        want = whole.narrow(case.out_axis, r * whole.shape[case.out_axis]
                            // m, whole.shape[case.out_axis] // m)
        bitwise.append(bool(torch.equal(got, want)))
        d = (got.float() - want.float()).abs()
        diff = max(diff, float(d.max()))
        within &= bool((d <= ATOL + RTOL * want.float().abs()).all())
    return dict(name=case.name, case=case.label,
                dtype=str(case.args[0].dtype).removeprefix("torch."),
                splits_whole=case.splits(case.kv),
                splits_rank=case.splits(case.kv // m),
                bitwise=bitwise, max_abs_diff=diff, within_tol=within)


def verdict(row: Dict[str, object]) -> bool:
    """The rule: bit for bit in fp32 and at equal split counts, within
    ATOL + RTOL · |whole| otherwise."""
    exact = row["dtype"] == "float32" \
        or row["splits_whole"] == row["splits_rank"]
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
