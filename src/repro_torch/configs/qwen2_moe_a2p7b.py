"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 MoE [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.config.base import ArchFamily, ModelConfig, MoEConfig
from repro_torch.config.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family=ArchFamily.MOE,
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=151936,
        qkv_bias=True,
        moe=MoEConfig(
            num_experts=60,
            num_experts_per_tok=4,
            num_shared_experts=4,
            expert_ff_dim=1408,
            shared_ff_dim=5632,   # 4 shared experts fused: 4 * 1408
        ),
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-reduced",
        family=ArchFamily.MOE,
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=96,
        vocab_size=512,
        qkv_bias=True,
        moe=MoEConfig(
            num_experts=4,
            num_experts_per_tok=2,
            num_shared_experts=1,
            expert_ff_dim=96,
            shared_ff_dim=96,
        ),
        source="reduced",
    )


register("qwen2-moe-a2.7b", full, reduced)
