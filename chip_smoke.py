"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, one JSON line each:

1. env       the card (nvidia-smi name and power limit), torch and CUDA
             versions; TF32 off for fp32 products.
2. build     nvcc builds every CUDA kernel of the port (one process per
             source, all at once); the Triton kernel compiles at first call.
3. kernels   each of the 4 kernels against its plain PyTorch version on the
             card at the serving path's shapes in bf16 (the fp32 plain
             version is the reference), with CUDA-event timings (median of
             30 runs after warm-up, L2 flushed before each run) of the
             kernel, its plain version and the nearest PyTorch library call,
             and the least time the card could take (bound_ms).
4. reference full-width granite-3-8b cut to 2 layers: the kernels' path on
             the card in bf16 against the plain path on the CPU in fp32 with
             the same weights, over a prefill and a few decode steps.
5. serve_contiguous / serve_paged
             the engine at full granite-3-8b width (40 layers, random
             weights from seed 0) through `repro_torch.launch.serve.run`:
             12 requests of 32-480 prompt tokens, chunked prefill on 2
             lanes, policy `memory`, each path's kernel launches counted.

Then the card's name and power limit, the `{"kernels": [...]}` summary,
and as the last line `{"ok": true, "device": {...}}`. Any failure raises:
the script exits non-zero and prints no result. It also refuses to run
without a GPU or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out"

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense bf16 FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
#: bf16 kernel output against the fp32 plain version
ATOL = RTOL = 2e-2

SERVE_ARGS = ["--variant", "full", "--policy", "memory", "--b-max", "8",
              "--batch-buckets", "1,2,4,8", "--chunked", "--lanes", "2",
              "--chunk-budget", "512", "--max-context", "1024",
              "--block-size", "16", "--pool-tokens", "8192",
              "--max-new", "32", "--seed", "0", "--device", "cuda"]
N_REQUESTS, PROMPT_LO, PROMPT_HI = 12, 32, 480
STRUCTURAL = ("decode_steps", "mean_batch", "admitted", "preemptions",
              "prefill_tokens", "finished")


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    """Max abs error; raises when any element is outside atol + rtol|want|."""
    d = (got.float() - want.float()).abs()
    bad = d > ATOL + RTOL * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()) or bool(bad.any()):
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"max abs err {float(d.max())}")
    return float(d.max())


# ---------------------------------------------------------------------------
# phase 3: kernels


def kernel_cases(dev):
    """(kernel, label, kernel call, plain call, fp32 plain call, library
    call or None, bytes, operations) at the serving path's shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    H, KV, hd, d = 32, 8, 128, 4096

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    cases = []
    for B, S in ((1, 1024), (1, 1000), (8, 1024), (8, 1000)):
        q, k, v = rn(B, H, hd), rn(B, S, KV, hd), rn(B, S, KV, hd)
        qp = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
        kp = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
        mask = (kp >= 0)[:, None, None, :]
        qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        cases.append((
            "decode_attention", f"B={B} S={S}",
            lambda q=q, k=k, v=v, qp=qp, kp=kp: ops.decode_attention(q, k, v, qp, kp),
            lambda q=q, k=k, v=v, qp=qp, kp=kp: ref.decode_attention_ref(q, k, v, qp, kp),
            lambda q=q, k=k, v=v, qp=qp, kp=kp: ref.decode_attention_ref(
                q.float(), k.float(), v.float(), qp, kp),
            lambda qs=qs, ks=ks, vs=vs, m=mask: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=m, enable_gqa=True),
            nbytes(q, k, v, qp, kp, q), 4 * hd * H * S * B))

    # paged: the serving pool (8192 tokens in blocks of 16), tables of 64
    # entries with shuffled physical ids and -1 tails
    NB, bs, MB, B = 512, 16, 64, 8
    kpool, vpool = rn(NB, bs, KV, hd), rn(NB, bs, KV, hd)
    q = rn(B, H, hd)
    perm = torch.randperm(NB, generator=g, device=dev)
    lens = [1024, 1000, 777, 512, 301, 160, 33, 1]
    tables = torch.full((B, MB), -1, dtype=torch.int32, device=dev)
    kpos = torch.full((NB, bs), -1, dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lens):
        nb = -(-n // bs)
        ids = perm[used:used + nb]
        used += nb
        tables[b, :nb] = ids.to(torch.int32)
        pos = torch.arange(nb * bs, dtype=torch.int32, device=dev)
        kpos[ids] = torch.where(pos < n, pos, -1).reshape(nb, bs)
    qp = torch.tensor([n - 1 for n in lens], dtype=torch.int32, device=dev)
    blocks = int((tables >= 0).sum())
    paged = (q, kpool, vpool, qp, kpos, tables)
    blk_bytes = bs * KV * hd * 2 * 2 + bs * 4
    cases.append((
        "paged_decode_attention", f"B={B} blocks={blocks}",
        lambda a=paged: ops.paged_decode_attention(*a),
        lambda a=paged: ref.paged_decode_attention_ref(*a),
        lambda a=paged: ref.paged_decode_attention_ref(
            a[0].float(), a[1].float(), a[2].float(), *a[3:]),
        None, blocks * blk_bytes + nbytes(q, qp, tables, q),
        4 * hd * H * sum(lens)))

    # prefill: a chunk of Tq queries ending at position 496 against a
    # 1024-slot cache row filled up to it (slots past it empty)
    Tk = 1024
    for Tq in (16, 500):
        end = max(496, Tq)
        q, k, v = rn(1, Tq, H, hd), rn(1, Tk, KV, hd), rn(1, Tk, KV, hd)
        qp = torch.arange(end - Tq, end, dtype=torch.int32, device=dev)[None]
        ar = torch.arange(Tk, dtype=torch.int32, device=dev)
        kp = torch.where(ar < end, ar, -1)[None]
        mask = ((kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None]))[:, None]
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        pairs = int(mask.sum())
        cases.append((
            "flash_attention", f"Tq={Tq} Tk={Tk}",
            lambda q=q, k=k, v=v, qp=qp, kp=kp: ops.flash_attention(q, k, v, qp, kp),
            lambda q=q, k=k, v=v, qp=qp, kp=kp: ref.flash_attention_ref(q, k, v, qp, kp),
            lambda q=q, k=k, v=v, qp=qp, kp=kp: ref.flash_attention_ref(
                q.float(), k.float(), v.float(), qp, kp),
            lambda qs=qs, ks=ks, vs=vs, m=mask: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=m, enable_gqa=True),
            nbytes(q, q, qp) + end * KV * hd * 2 * 2 + end * 4,
            4 * hd * H * pairs))

    for rows in (8, 4096):
        x, w = rn(rows, d), rn(d) * 0.1
        w1 = 1.0 + w
        cases.append((
            "rmsnorm", f"rows={rows} d={d}",
            lambda x=x, w=w: ops.rmsnorm(x, w),
            lambda x=x, w=w: ref.rmsnorm_ref(x, w),
            lambda x=x, w=w: ref.rmsnorm_ref(x.float(), w.float()),
            lambda x=x, w1=w1: F.rms_norm(x, (d,), weight=w1, eps=1e-6),
            nbytes(x, w, x), 4 * rows * d))
    return cases


#: kernel -> (route, source, the TPU kernel it replaces, main-path case)
KERNELS = {
    "decode_attention": (
        "cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:83", "B=8 S=1024"),
    "paged_decode_attention": (
        "cuda", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:139", None),
    "flash_attention": (
        "cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:61", "Tq=16 Tk=1024"),
    "rmsnorm": (
        "triton", "src/repro_torch/kernels/rmsnorm.py",
        "src/repro/kernels/rmsnorm.py:25", "rows=8 d=4096"),
}


def run_kernels(dev):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    results = []
    for name, label, kern, plain, plain32, lib, n_bytes, n_ops in \
            kernel_cases(dev):
        got = kern()
        torch.cuda.synchronize()
        err = max_err(got, plain32())
        b_ms, b_by = bound(n_bytes, n_ops)
        r = dict(name=name, case=label, max_abs_err=err, tol=ATOL,
                 ms=time_ms(kern, flush), plain_ms=time_ms(plain, flush),
                 library_ms=time_ms(lib, flush) if lib else None,
                 bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, ops=n_ops)
        emit("kernels", **r)
        results.append(r)
    return results


# ---------------------------------------------------------------------------
# phase 4: reference


def run_reference(dev):
    """Full width, depth cut to 2 layers: the kernels' path (bf16, card)
    against the plain path (fp32, CPU) with the same weights."""
    import dataclasses
    from repro_torch.config.registry import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("granite-3-8b", "full"),
                              num_layers=2)
    m = build_model(cfg, torch.bfloat16, dev)
    params = m.init(0)
    m_cpu = build_model(cfg, torch.float32, "cpu")

    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.float().cpu()

    p_cpu = to_cpu(params)
    T, n_dec = 64, 4
    toks = torch.randint(0, cfg.vocab_size, (1, T + n_dec),
                         generator=torch.Generator().manual_seed(0))
    pos = torch.arange(T + n_dec, dtype=torch.int32)[None]
    outs = []
    for model, p, d in ((m, params, dev), (m_cpu, p_cpu, "cpu")):
        cache = model.init_cache(1, 128)
        lg, cache = model.prefill(p, toks[:, :T].to(d), pos[:, :T].to(d),
                                  cache)
        seq = [lg[0, -1]]
        for t in range(T, T + n_dec):
            lg, cache = model.decode_step(p, toks[:, t].to(d),
                                          pos[:, t].to(d), cache)
            seq.append(lg[0])
        outs.append(torch.stack(seq).float().cpu())
    got, want = outs
    if got.shape != (n_dec + 1, cfg.vocab_size) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"bad logits: shape {tuple(got.shape)}")
    rel = float((got - want).abs().max() / want.abs().max())
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    emit("reference", layers=2, d_model=cfg.d_model, rel_max_err=rel,
         tol=5e-2, argmax_agreement=same)
    if rel > 5e-2:
        raise AssertionError(f"kernel path vs fp32 plain path: rel err {rel}")
    del m, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: serving


def run_serve(paged: bool):
    import numpy as np
    from repro_torch.config.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(
        SERVE_ARGS + (["--paged"] if paged else []))
    vocab = get_config(args.arch, args.variant).vocab_size
    rng = np.random.RandomState(0)
    prompts = [list(map(int, rng.randint(0, vocab, size=rng.randint(
        PROMPT_LO, PROMPT_HI + 1)))) for _ in range(N_REQUESTS)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    eng = serve.run(args, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    s = eng.summary()
    n_out = eng.total_decoded
    name = "serve_paged" if paged else "serve_contiguous"
    emit(name, summary=s, launches=launches, wall_s=wall,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         tokens_out=n_out)
    if s["finished"] != N_REQUESTS:
        raise AssertionError(f"{name}: {s['finished']} of {N_REQUESTS} "
                             f"requests finished")
    path = ("paged_decode_attention" if paged else "decode_attention",
            "flash_attention", "rmsnorm")
    for k in path:
        if launches[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched")
    del eng
    torch.cuda.empty_cache()
    return s, launches


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
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in logs.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

    kres = run_kernels(dev)
    run_reference(dev)
    s_c, l_c = run_serve(paged=False)
    s_p, l_p = run_serve(paged=True)
    diff = {k: (s_c[k], s_p[k]) for k in STRUCTURAL if s_c[k] != s_p[k]}
    if diff:
        raise AssertionError(f"structural counters differ between cache "
                             f"layouts: {diff}")
    launches = {k: l_c[k] + l_p[k] for k in l_c}
    if any(n <= 0 for n in launches.values()):
        raise AssertionError(f"a kernel never launched: {launches}")

    summary = []
    for name, (route, source, replaces, case) in KERNELS.items():
        rows = [r for r in kres if r["name"] == name]
        main_row = next(r for r in rows if case is None or r["case"] == case)
        summary.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], case=main_row["case"]))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kres, "summary": summary,
         "serve_contiguous": s_c, "serve_paged": s_p,
         "launches": launches}, indent=1))
    print(card)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
