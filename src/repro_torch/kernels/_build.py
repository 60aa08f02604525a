"""Build and load the port's CUDA kernels: `nvcc` for sm_90a into shared
libraries with a plain C interface, loaded with ctypes.

Each `csrc/<name>.cu` becomes `build/kernels/lib<name>.so` at the root of
the checkout, built at first use when it is missing or older than its
source (or all anew by `build_all`, which starts one `nvcc` per source at
once). Every C entry returns `cudaGetLastError()` after its
launch; `check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: ctypes signatures of every C entry, by library name
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES: Dict[str, Dict[str, List]] = {
    "decode_attention": {
        # dtype, q, k, v, q_pos, k_pos, out, part_o, part_ml,
        # B, H, KV, hd, S, window, n_splits, stream
        "decode_attention": [_I] + [_P] * 8 + [_I] * 7 + [_P],
        # dtype, q, k_pool, v_pool, q_pos, kpos_pool, tables, out, part_o,
        # part_ml, B, H, KV, hd, block_size, MB, window, n_splits, stream
        "paged_decode_attention": [_I] + [_P] * 9 + [_I] * 8 + [_P],
        # dtype, q, k, v, q_pos, k_pos, o, ml, part_o, part_ml,
        # B, H, KV, hd, S, window, n_splits, stream
        "decode_attention_partial": [_I] + [_P] * 9 + [_I] * 7 + [_P],
        # dtype, o, ml, out, R, rows, hd, stream
        "attention_combine": [_I] + [_P] * 3 + [_I] * 3 + [_P],
    },
    "flash_attention": {
        # dtype, kernel, q, k, v, q_pos, k_pos, out, part_o, part_ml,
        # B, Tq, Tk, H, KV, hd, window, causal, n_splits, stream
        "flash_attention": [_I] * 2 + [_P] * 8 + [_I] * 9 + [_P],
        # kernel, q, k_pool, v_pool, q_pos, kpos_pool, tables, out, part_o,
        # part_ml, B, Tq, H, KV, hd, NB, block_size, MB, window, causal,
        # n_splits, stream
        "paged_flash_attention": [_I] + [_P] * 9 + [_I] * 11 + [_P],
    },
    "rmsnorm": {
        # dtype, x, w, out, rows, d, eps, stream
        "rmsnorm": [_I] + [_P] * 3 + [_I] * 2 + [_F, _P],
        # dtype, x, y, w, sum_out, out, rows, d, eps, stream
        "add_rmsnorm": [_I] + [_P] * 5 + [_I] * 2 + [_F, _P],
        # dtype, x, ss, rows, d, stream
        "rmsnorm_sumsq": [_I] + [_P] * 2 + [_I] * 2 + [_P],
        # dtype, x, ss, w, out, rows, d, d_total, eps, stream
        "rmsnorm_scale": [_I] + [_P] * 4 + [_I] * 3 + [_F, _P],
    },
    "ssd_scan": {
        # xdt, cum_a, Br, Cr, y, s, Z, Q, H, P, N, stream
        "ssd_intra": [_P] * 6 + [_I] * 5 + [_P],
    },
    "rglru_scan": {
        # a, bx, h0, y, hT, B, T, W, vec, lane groups, segments, steps a
        # segment, carry groups, stream
        "rglru_scan": [_P] * 5 + [_I] * 8 + [_P],
        # dtype, ga, gi, x, lam, b_a, b_i, h0, y, hT, B, T, W, vec, lane
        # groups, segments, steps a segment, carry groups, stream
        "rglru_gated_scan": [_I] + [_P] * 9 + [_I] * 8 + [_P],
        # gated
        "rglru_max_steps": [_I],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Missing, or older than its source or any shared header."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def _start(name: str):
    """Start one nvcc into a temporary file beside the library (renamed into
    place on success, so concurrent builders never load a partial file)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: str) -> str:
    """Wait for nvcc; returns its output (ptxas: registers, spills)."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, _lib_path(name))
    return out


def build_all() -> Dict[str, str]:
    """Build every library anew, one nvcc per source, all at once. Returns
    the build log per library (ptxas: registers, spills)."""
    started = {n: _start(n) for n in SIGNATURES}
    logs, errors = {}, []
    for n, (proc, tmp) in started.items():
        try:
            logs[n] = _finish(n, proc, tmp)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if it is missing or stale."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if _stale(name):
        _finish(name, *_start(name))
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


#: the kernels' `dtype` argument
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def require(cond: bool, msg: str) -> None:
    """Validate a kernel argument before any pointer reaches the card."""
    if not cond:
        raise ValueError(msg)


def cuda_args(*tensors: torch.Tensor, dtype=None) -> List[int]:
    """Check that every tensor is a contiguous CUDA tensor (of `dtype`,
    and 16-byte aligned for the kernels' vector loads, if `dtype` is
    given) and return their data pointers. (The messages are formatted
    only on failure: this runs at every launch.)"""
    ptrs = []
    for t in tensors:
        p = t.data_ptr()
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError("kernel operand must be a contiguous CUDA tensor")
        if dtype is not None and (t.dtype != dtype or p % 16):
            raise ValueError(f"kernel operand must be a 16-byte aligned "
                             f"{dtype} tensor, got {t.dtype}")
        ptrs.append(p)
    return ptrs


def stream() -> int:
    """The current device's current CUDA stream, as a raw pointer. (The
    private binding skips building a `torch.cuda.Stream`: 0.10 against
    5.7 us a call, `bench/norm_host.py` on an H100 host.)"""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
