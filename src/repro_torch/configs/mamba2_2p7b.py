"""mamba2-2.7b — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.config.base import (ArchFamily, AttentionKind, ModelConfig,
                                     SSMConfig)
from repro_torch.config.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family=ArchFamily.SSM,
        num_layers=64,
        d_model=2560,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        attention=AttentionKind.NONE,
        tie_embeddings=True,
        ssm=SSMConfig(
            state_dim=128,
            head_dim=64,       # 80 SSD heads = expand*d_model/head_dim
            conv_width=4,
            chunk_size=256,
            expand=2,
        ),
        source="arXiv:2405.21060",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-reduced",
        family=ArchFamily.SSM,
        num_layers=2,
        d_model=128,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        attention=AttentionKind.NONE,
        tie_embeddings=True,
        ssm=SSMConfig(
            state_dim=16,
            head_dim=32,
            conv_width=4,
            chunk_size=32,
            expand=2,
        ),
        source="reduced",
    )


register("mamba2-2.7b", full, reduced)
