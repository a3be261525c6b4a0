"""Deterministic synthetic token pipeline with data-parallel sharding.

The port's own numpy copy of `repro.data.tokens`: batches are a pure
function of (seed, step, shard), so a restarted job regenerates exactly
the batch it failed on.  The arrays are the reference's, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticTokenDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0

    def __post_init__(self):
        assert self.global_batch % self.n_shards == 0
        self.local_batch = self.global_batch // self.n_shards

    def batch(self, step: int) -> np.ndarray:
        """(local_batch, seq_len) int32 tokens for this step and shard: a
        Markov-ish walk (each token the previous plus 1-16), so that the
        loss has something to learn."""
        rng = np.random.default_rng((self.seed * 1_000_003 + step) * 65_537 + self.shard)
        b, s, v = self.local_batch, self.seq_len, self.vocab_size
        base = rng.integers(0, v, (b, 1))
        steps = rng.integers(1, 17, (b, s - 1))
        toks = np.concatenate([base, steps], axis=1).cumsum(axis=1) % v
        return toks.astype(np.int32)

    def frontend_embeddings(self, step: int, n_tokens: int, d: int) -> np.ndarray:
        """Stub modality frontend: precomputed patch / frame embeddings."""
        rng = np.random.default_rng(self.seed * 7 + step * 13 + self.shard)
        return rng.normal(0, 0.02, (self.local_batch, n_tokens, d)).astype(np.float32)
