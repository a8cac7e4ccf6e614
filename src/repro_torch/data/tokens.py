"""Deterministic, step-indexed synthetic token pipeline.

A copy of the JAX package's ``data/tokens.py`` (numpy only), kept in the
port so that the port imports nothing of the reference: the same tokens
for the same (seed, step, shard).

Batches are a pure function of (seed, step, shard) — exactly the property
fault-tolerant training needs: replaying a step after restore consumes the
identical batch, and elastic rescaling re-partitions deterministically.

The stream is a order-2 Markov chain over the vocab (so small models have
signal to learn, unlike uniform noise).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig):
        assert cfg.batch % cfg.n_shards == 0
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        k = min(cfg.vocab, 64)
        self._proj = rng.integers(0, cfg.vocab, size=(k, k))

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        local = cfg.batch // cfg.n_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 97 + cfg.shard
        )
        k = self._proj.shape[0]
        toks = np.empty((local, cfg.seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, k, local)
        toks[:, 1] = rng.integers(0, k, local)
        noise = rng.random((local, cfg.seq_len + 1))
        for t in range(2, cfg.seq_len + 1):
            nxt = self._proj[toks[:, t - 1] % k, toks[:, t - 2] % k] % k
            rand = rng.integers(0, cfg.vocab, local)
            toks[:, t] = np.where(noise[:, t] < 0.1, rand, nxt)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
