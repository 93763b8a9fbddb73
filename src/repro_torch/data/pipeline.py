"""Synthetic sharded LM data pipeline (a copy of ``repro.data.pipeline``;
the batches are numpy and bit-equal to the reference's).

Deterministic per-(shard, step) token generation — every host materializes
only its shard of the global batch, which is how a 1000-node input pipeline
must behave (no host ever holds the global batch).  A mixture of Zipfian
unigram sampling and repeated-ngram structure gives the loss a learnable
signal (used by examples/train_lm.py and the convergence test).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_shards: int = 1
    shard_id: int = 0
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 16
    n_motifs: int = 64


class SyntheticLM:
    """Iterator of {'tokens', 'labels'} numpy batches for one host shard."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_shards == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_shards
        rng = np.random.default_rng(cfg.seed)
        # shared motif table (identical across shards: same seed)
        self.motifs = rng.integers(
            0, cfg.vocab_size, size=(cfg.n_motifs, cfg.motif_len), dtype=np.int32
        )
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self.unigram = p / p.sum()

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.shard_id
        )
        toks = rng.choice(
            cfg.vocab_size, size=(self.local_batch, cfg.seq_len + 1),
            p=self.unigram,
        ).astype(np.int32)
        # plant motifs: structure the model can learn
        for row in range(self.local_batch):
            n_plant = rng.integers(2, 6)
            for _ in range(n_plant):
                m = self.motifs[rng.integers(0, cfg.n_motifs)]
                start = rng.integers(0, cfg.seq_len + 1 - cfg.motif_len)
                toks[row, start : start + cfg.motif_len] = m
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_batch_fn(cfg: DataConfig):
    ds = SyntheticLM(cfg)
    return ds.batch
