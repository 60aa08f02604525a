"""recurrentgemma-9b — RG-LRU + local attention, 2:1 pattern [arXiv:2402.19427]."""
from repro_torch.config.base import (ArchFamily, AttentionKind, ModelConfig,
                                     RGLRUConfig)
from repro_torch.config.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family=ArchFamily.HYBRID,
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,            # MQA in the local-attention blocks
        d_ff=12288,
        vocab_size=256000,
        head_dim=256,              # paper: head_dim 256 (16 heads x 256)
        attention=AttentionKind.LOCAL_HYBRID,
        rglru=RGLRUConfig(
            lru_width=4096,
            conv_width=4,
            window_size=2048,
            block_pattern=("recurrent", "recurrent", "attention"),
        ),
        source="arXiv:2402.19427",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-reduced",
        family=ArchFamily.HYBRID,
        num_layers=3,              # one full recurrent/recurrent/attention pattern
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        attention=AttentionKind.LOCAL_HYBRID,
        rglru=RGLRUConfig(
            lru_width=128,
            conv_width=4,
            window_size=64,
            block_pattern=("recurrent", "recurrent", "attention"),
        ),
        source="reduced",
    )


register("recurrentgemma-9b", full, reduced)
