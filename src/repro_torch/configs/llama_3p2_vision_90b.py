"""llama-3.2-vision-90b — 100L total: 80 self-attn decoder + 20 cross-attn
image layers (one every 4 decoder layers) [hf:meta-llama/Llama-3.2-11B-Vision].

The ViT vision tower + projector is a stub: a request carries precomputed
patch embeddings of shape (1, num_patches, d_model) as
`extras={"images": ...}`, projected into the cross-attention K/V on the
request's first prefill chunk.
"""
from repro_torch.config.base import ArchFamily, ModelConfig
from repro_torch.config.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family=ArchFamily.VLM,
        num_layers=80,            # self-attention decoder layers
        num_cross_layers=20,      # + 20 cross-attn layers = 100L total
        vlm_cross_every=4,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        rope_theta=500000.0,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-reduced",
        family=ArchFamily.VLM,
        num_layers=2,
        num_cross_layers=1,
        vlm_cross_every=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        source="reduced",
    )


register("llama-3.2-vision-90b", full, reduced)
