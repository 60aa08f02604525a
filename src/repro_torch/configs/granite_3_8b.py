"""granite-3-8b — dense GQA [hf:ibm-granite/granite-3.0-2b-base family]."""
from repro_torch.config.base import ArchFamily, ModelConfig
from repro_torch.config.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family=ArchFamily.DENSE,
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
        tie_embeddings=True,
        source="hf:ibm-granite/granite-3.0-2b-base",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b-reduced",
        family=ArchFamily.DENSE,
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        tie_embeddings=True,
        source="reduced",
    )


register("granite-3-8b", full, reduced)
