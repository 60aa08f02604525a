"""mistral-nemo-12b — dense GQA, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

Model card uses head_dim=128 (not d_model/num_heads=160); we follow the card.
For the long_500k shape the dry-run uses the sliding-window variant (window
4096) per DESIGN §4 — full attention at 524k tokens/request is out of scope.
"""
import dataclasses

from repro_torch.config.base import ArchFamily, AttentionKind, ModelConfig
from repro_torch.config.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        family=ArchFamily.DENSE,
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=131072,
        head_dim=128,
        rope_theta=1_000_000.0,
        source="hf:mistralai/Mistral-Nemo-Base-2407",
    )


def sliding(window: int = 4096) -> ModelConfig:
    return dataclasses.replace(
        full(), name="mistral-nemo-12b-swa",
        attention=AttentionKind.SLIDING, sliding_window=window)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-reduced",
        family=ArchFamily.DENSE,
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        source="reduced",
    )


register("mistral-nemo-12b", full, reduced)
