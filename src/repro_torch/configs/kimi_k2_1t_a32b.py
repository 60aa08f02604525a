"""kimi-k2-1t-a32b — trillion-param MoE, 384 routed experts top-8 [arXiv:2501.kimi2].

Routed experts: 61L x (3 * 7168 * 2048 * 384) ~ 1.03T params; top-8 active
~32B. One shared expert per the K2 card.
"""
from repro_torch.config.base import ArchFamily, ModelConfig, MoEConfig
from repro_torch.config.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b",
        family=ArchFamily.MOE,
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=163840,
        moe=MoEConfig(
            num_experts=384,
            num_experts_per_tok=8,
            num_shared_experts=1,
            expert_ff_dim=2048,
            shared_ff_dim=2048,
        ),
        source="arXiv:2501.kimi2",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b-reduced",
        family=ArchFamily.MOE,
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=64,
        vocab_size=512,
        moe=MoEConfig(
            num_experts=4,
            num_experts_per_tok=2,
            num_shared_experts=1,
            expert_ff_dim=64,
            shared_ff_dim=64,
        ),
        source="reduced",
    )


register("kimi-k2-1t-a32b", full, reduced)
