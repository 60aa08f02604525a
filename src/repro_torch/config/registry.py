"""Architecture registry: --arch <id> -> ModelConfig (full + reduced variants).

The port knows every arch id the JAX package knows, so the serving CLI
offers the same `--arch` choices; only the ids in `_PORTED` have a
configuration module here yet, and the others raise "not yet ported".
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List

from repro_torch.config.base import ModelConfig

_REGISTRY: Dict[str, Dict[str, Callable[[], ModelConfig]]] = {}

# module names can't contain '-' or '.', map arch ids to module names
_ARCH_MODULES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen1.5-32b": "qwen1p5_32b",
    "granite-3-8b": "granite_3_8b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "starcoder2-7b": "starcoder2_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "mamba2-2.7b": "mamba2_2p7b",
    "llama-3.2-vision-90b": "llama_3p2_vision_90b",
}

#: arch ids whose model path the port runs (ROADMAP.md lists the rest)
_PORTED = ("granite-3-8b",
           "mamba2-2.7b", "recurrentgemma-9b")


def register(arch_id: str, full: Callable[[], ModelConfig],
             reduced: Callable[[], ModelConfig]) -> None:
    _REGISTRY[arch_id] = {"full": full, "reduced": reduced}


def _ensure_loaded(arch_id: str) -> None:
    if arch_id in _REGISTRY:
        return
    mod = _ARCH_MODULES.get(arch_id)
    if mod is None:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    if arch_id not in _PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not yet ported to repro_torch; "
            f"ported: {list(_PORTED)}")
    importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str, variant: str = "full") -> ModelConfig:
    _ensure_loaded(arch_id)
    return _REGISTRY[arch_id][variant]()


def list_archs() -> List[str]:
    return sorted(_ARCH_MODULES)
