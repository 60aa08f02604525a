"""Checkpoints as one `.npz` of named leaves plus a `.meta.json`, the JAX
package's format (`training/checkpoint.py`), so that a checkpoint the JAX
package writes loads into the port.

Keys are `params/<path>` and `opt/<path>` (`opt/m/...`, `opt/v/...`,
`opt/step`), paths joined by "/" over the nested dicts; the meta file
holds {"step", "keys"}. numpy has no bfloat16, so bf16 leaves are stored as
fp32, which holds every bf16 value exactly, and cast back to the leaf's
dtype on load: the round trip is bit for bit in either dtype.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.params import named_leaves


def _base(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def save_checkpoint(path: str, params, opt_state, step: int) -> None:
    base = _base(path)
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    flat = {name: _to_numpy(t) for name, t in named_leaves(
        {"params": params, "opt": opt_state})}
    np.savez(base, **flat)
    with open(base + ".meta.json", "w") as f:
        json.dump({"step": step, "keys": sorted(flat)}, f)


def load_checkpoint(path: str, params_like, opt_like
                    ) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """(params, opt_state, step) with the structure, dtypes, devices and
    requires_grad of `params_like` / `opt_like`."""
    base = _base(path)
    with open(base + ".meta.json") as f:
        meta = json.load(f)
    with np.load(base) as data:
        def rebuild(like, prefix):
            if isinstance(like, dict):
                return {k: rebuild(v, f"{prefix}{k}/")
                        for k, v in like.items()}
            t = torch.from_numpy(np.asarray(data[prefix[:-1]])).to(
                like.device, like.dtype)
            return t.requires_grad_(like.requires_grad)
        return (rebuild(params_like, "params/"), rebuild(opt_like, "opt/"),
                meta["step"])
