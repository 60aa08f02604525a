"""Token sampling for the serving engine."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0, top_k: int = 0):
    """logits: (B, V) fp32 -> (B,) int64 tokens. Greedy argmax at
    temperature 0; otherwise a draw from softmax(logits / temperature),
    restricted to the top_k logits when top_k > 0."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k:
        kth = logits.topk(top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
