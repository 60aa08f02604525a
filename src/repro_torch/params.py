"""Convert the JAX package's param pytree into the port's params.

The caller hands over the pytree as nested dicts of numpy arrays (a test
does `jax.device_get`, so the port never sees JAX). The nested-dict,
stacked-L layout and the `x @ w` orientation are kept as they are, so both
packages run the same weights.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.backbone import FP32_LEAVES


def from_jax_params(tree: Dict[str, Any], device="cpu",
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on `device`:
    float leaves in `dtype`, except those the JAX package keeps in fp32
    whatever the working dtype (`backbone.FP32_LEAVES`: the SSM and RG-LRU
    constants), which stay fp32; integer arrays keep their type."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = from_jax_params(v, device, dtype)
            continue
        a = np.array(v)
        if a.dtype.name == "bfloat16":   # ml_dtypes: torch cannot wrap it
            a = a.astype(np.float32)
        t = torch.from_numpy(a)
        if t.is_floating_point():
            t = t.to(torch.float32 if k in FP32_LEAVES else dtype)
        out[k] = t.to(device)
    return out
