"""Synthetic data pipeline: deterministic, shardable token streams.

Generates Zipf-distributed "documents" joined by EOS, packed into fixed
(batch, seq) examples. Deterministic per (seed, shard, step) so multi-host
training is reproducible and each data-parallel rank reads disjoint streams
without coordination — the moral equivalent of a deterministic tfds pipeline
at laptop scale.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int  # per-shard batch
    seed: int = 0
    mean_doc_len: int = 512
    eos_id: int = 0
    zipf_a: float = 1.2


class SyntheticTokens:
    """Iterator of {"tokens": (B, S) int32, "targets": (B, S) int32}."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards

    def example(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + self.shard
        )
        B, S = cfg.batch_size, cfg.seq_len
        stream = np.empty((B, S + 1), dtype=np.int64)
        for b in range(B):
            toks = []
            while len(toks) < S + 1:
                n = max(8, int(rng.exponential(cfg.mean_doc_len)))
                doc = rng.zipf(cfg.zipf_a, size=n) % (cfg.vocab_size - 1) + 1
                toks.extend(doc.tolist())
                toks.append(cfg.eos_id)
            stream[b] = np.asarray(toks[: S + 1])
        return {
            "tokens": stream[:, :-1].astype(np.int32),
            "targets": stream[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.example(step)
            step += 1
