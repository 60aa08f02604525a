"""starcoder2-7b — dense GQA, RoPE [arXiv:2402.19173]."""
from repro_torch.config.base import ArchFamily, ModelConfig
from repro_torch.config.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family=ArchFamily.DENSE,
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        d_ff=18432,
        vocab_size=49152,
        source="arXiv:2402.19173",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b-reduced",
        family=ArchFamily.DENSE,
        num_layers=2,
        d_model=144,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        source="reduced",
    )


register("starcoder2-7b", full, reduced)
