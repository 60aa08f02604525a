"""seamless-m4t-medium — enc-dec multimodal backbone [arXiv:2308.11596].

The mel/conv audio frontend is a stub: a request carries precomputed frame
embeddings of shape (1, frames, d_model) as `extras={"enc_frames": ...}`,
which the encoder reads on the request's first prefill chunk.
"""
from repro_torch.config.base import ArchFamily, ModelConfig
from repro_torch.config.registry import register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family=ArchFamily.ENCDEC,
        num_layers=12,             # decoder layers
        encoder_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        source="arXiv:2308.11596",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium-reduced",
        family=ArchFamily.ENCDEC,
        num_layers=2,
        encoder_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        source="reduced",
    )


register("seamless-m4t-medium", full, reduced)
