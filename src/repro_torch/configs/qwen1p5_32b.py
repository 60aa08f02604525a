"""qwen1.5-32b — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B family scaled]."""
from repro_torch.config.base import ArchFamily, ModelConfig
from repro_torch.config.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family=ArchFamily.DENSE,
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        source="hf:Qwen/Qwen1.5-0.5B",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b-reduced",
        family=ArchFamily.DENSE,
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        qkv_bias=True,
        source="reduced",
    )


register("qwen1.5-32b", full, reduced)
