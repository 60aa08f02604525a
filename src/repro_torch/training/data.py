"""Synthetic but learnable batches, the port's copy of the JAX package's
`training/data.py` (numpy only, so both packages draw the same batches
bit for bit from the same seed).

Tokens follow a fixed-seed Markov chain over the vocabulary: each token
has `branching` likely successors, so a correct model's loss falls. The
VLM and enc-dec families add stub image / frame embeddings (B, 64, d) in
fp32.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.config.base import ArchFamily, ModelConfig, TrainConfig


class MarkovData:
    def __init__(self, cfg: ModelConfig, train: TrainConfig,
                 branching: int = 4):
        self.cfg = cfg
        self.train = train
        rng = np.random.RandomState(train.seed)
        # sparse transition table: each token's `branching` successors
        self.next_tokens = rng.randint(0, cfg.vocab_size,
                                       size=(cfg.vocab_size, branching))
        self.rng = np.random.RandomState(train.seed + 1)

    def sample_tokens(self, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), np.int32)
        cur = self.rng.randint(0, self.cfg.vocab_size, size=batch)
        for t in range(seq):
            out[:, t] = cur
            choice = self.rng.randint(0, self.next_tokens.shape[1],
                                      size=batch)
            cur = self.next_tokens[cur, choice]
        return out

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        t = self.train
        d = self.cfg.d_model
        while True:
            b: Dict[str, np.ndarray] = {
                "tokens": self.sample_tokens(t.global_batch, t.seq_len)}
            if self.cfg.family == ArchFamily.ENCDEC:
                b["enc_frames"] = self.rng.randn(
                    t.global_batch, 64, d).astype(np.float32)
            if self.cfg.family == ArchFamily.VLM:
                b["images"] = self.rng.randn(
                    t.global_batch, 64, d).astype(np.float32)
            yield b
