"""Deterministic, shard-aware, resumable synthetic token pipeline.

A copy of ``src/repro/data/pipeline.py`` (numpy only), so the port's
batches are the reference's, bit for bit.

Every batch is a pure function of ``(seed, step, dp_rank)`` via counter
based Philox keys — no iterator state exists, so:

  * restart at step k reproduces batch k bit-exactly (checkpoint/restart
    correctness, verified by tests);
  * each data-parallel rank draws only its shard (no host reads the
    global batch);
  * elastic resharding (changing dp_world) re-partitions the same global
    stream: global sample index = step * global_batch + position, and a
    rank owns a contiguous slice of positions.

Token content follows a Zipf-like unigram draw with a deterministic
bigram skeleton so the LM loss actually decreases during the example
training runs (pure-uniform tokens have irreducible loss == log V).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataSpec:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # unigram skew


class SyntheticTokens:
    """Stateless batch source; ``batch(step, rank, world)`` is pure."""

    def __init__(self, spec: DataSpec):
        self.spec = spec
        # fixed Zipf unigram distribution over the vocab
        ranks = np.arange(1, spec.vocab + 1, dtype=np.float64)
        probs = ranks ** (-spec.zipf_a)
        self._probs = probs / probs.sum()
        # deterministic bigram successor table: token t is often followed
        # by succ[t]; gives the model something learnable
        rng = np.random.default_rng(np.random.Philox(key=spec.seed))
        self._succ = rng.integers(0, spec.vocab, size=spec.vocab)

    def local_batch_size(self, world: int) -> int:
        gb = self.spec.global_batch
        if gb % world:
            raise ValueError(f"global_batch {gb} not divisible by dp world {world}")
        return gb // world

    def batch(self, step: int, rank: int = 0, world: int = 1) -> dict:
        """Returns {tokens (b, S) i32, labels (b, S) i32} for this rank."""
        spec = self.spec
        b = self.local_batch_size(world)
        start = step * spec.global_batch + rank * b
        rows = []
        for i in range(b):
            rng = np.random.default_rng(
                np.random.Philox(key=(spec.seed, start + i))
            )
            draws = rng.choice(spec.vocab, size=spec.seq_len + 1, p=self._probs)
            follow = rng.random(spec.seq_len + 1) < 0.5
            seq = draws.copy()
            # 50% of positions follow the bigram skeleton of the previous token
            for t in range(1, spec.seq_len + 1):
                if follow[t]:
                    seq[t] = self._succ[seq[t - 1]]
            rows.append(seq)
        arr = np.stack(rows).astype(np.int32)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def iterate(self, start_step: int, rank: int = 0, world: int = 1
                ) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step, rank, world)
            step += 1


def make_pipeline(vocab: int, seq_len: int, global_batch: int,
                  seed: int = 0) -> SyntheticTokens:
    return SyntheticTokens(DataSpec(vocab, seq_len, global_batch, seed))
