"""A dense decoder's configuration file as the port's `ModelConfig`.

The port models no µP multipliers (Granite's embedding, residual,
attention and logits multipliers): a file that states one other than the
plain value is refused, never served as something else."""
from __future__ import annotations

from typing import Dict

#: keys whose value the port's equations fix, and that value
PLAIN = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
         "logits_scaling": 1.0, "attention_bias": False, "mlp_bias": False}


def port_config(name: str, c: Dict):
    from repro_torch.config.base import ArchFamily, ModelConfig

    for k, v in PLAIN.items():
        if k in c and c[k] != v:
            raise ValueError(f"{name}: the port serves {k} = {v!r} only, "
                             f"the file states {c[k]!r}")
    hd = int(c.get("head_dim") or 0)
    if "attention_multiplier" in c and \
            abs(c["attention_multiplier"] * (hd or c["hidden_size"]
                                             // c["num_attention_heads"])
                ** 0.5 - 1.0) > 1e-6:
        raise ValueError(f"{name}: the port scales scores by 1/sqrt(hd) "
                         f"only")
    if c.get("sliding_window"):
        raise ValueError(f"{name}: a sliding window is not this family's")
    return ModelConfig(
        name=name, family=ArchFamily.DENSE,
        num_layers=int(c["num_hidden_layers"]), d_model=int(c["hidden_size"]),
        num_heads=int(c["num_attention_heads"]),
        num_kv_heads=int(c["num_key_value_heads"]),
        d_ff=int(c["intermediate_size"]), vocab_size=int(c["vocab_size"]),
        head_dim=hd, rope_theta=float(c["rope_theta"]),
        rms_eps=float(c["rms_norm_eps"]),
        tie_embeddings=bool(c["tie_word_embeddings"]),
        dtype=str(c.get("torch_dtype", "bfloat16")), source=c["source"])
