"""Deterministic, elastic-friendly synthetic LM data pipeline — a copy
of the reference's ``data/pipeline.py`` (numpy only), so that the port's
batches are bit-equal to the reference's for every step, batch size and
host shard.

Every token is a pure function of its *global example index* — not of
the worker count — so a run restarted on a different data-parallel width
(elastic scaling) consumes exactly the same stream with no gaps or
repeats.  Per-host sharded loading: each host materializes only its
slice of the global batch.

The generator produces a Zipf-ish unigram mixture with Markov
second-order structure, so tiny models show a real, monotonically
decreasing loss (needed by the train-loss-decreases integration test and
the ~100M-model example run).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def _hash64(x: np.ndarray) -> np.ndarray:
    """splitmix64 — stateless, vectorized."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    return x ^ (x >> np.uint64(31))


@dataclass
class SyntheticLM:
    """Markov-structured synthetic corpus."""

    vocab_size: int
    seq_len: int
    seed: int = 0
    order_mix: float = 0.8      # P(next token from the Markov rule)

    def example(self, global_idx: int) -> np.ndarray:
        """Tokens of example `global_idx` — count-invariant."""
        n = self.seq_len + 1
        idx = np.uint64(global_idx)
        base = _hash64(np.arange(n, dtype=np.uint64)
                       + idx * np.uint64(1_000_003)
                       + np.uint64(self.seed) * np.uint64(7_777_777))
        # Zipf-ish unigram draw
        u = (base >> np.uint64(11)).astype(np.float64) / 2.0 ** 53
        zipf = np.minimum((1.0 / np.maximum(u, 1e-12)) ** 0.5,
                          self.vocab_size - 1).astype(np.int64)
        toks = zipf % self.vocab_size
        # second-order structure: with prob order_mix, token t is a fixed
        # function of tokens t-1, t-2 => learnable bigram/trigram signal
        gate = ((base & np.uint64(0xFF)).astype(np.float64) / 255.0
                < self.order_mix)
        out = toks.copy()
        for t in range(2, n):
            if gate[t]:
                out[t] = int((out[t - 1] * 31 + out[t - 2] * 7 + 11)
                             % self.vocab_size)
        return out

    def batch(self, step: int, global_batch: int,
              shard: Tuple[int, int] = (0, 1)
              ) -> Dict[str, np.ndarray]:
        """Host-sharded batch for `step`: shard=(host_idx, n_hosts)."""
        host, n_hosts = shard
        assert global_batch % n_hosts == 0
        per = global_batch // n_hosts
        start = step * global_batch + host * per
        rows = np.stack([self.example(start + i) for i in range(per)])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}

    def stream(self, global_batch: int, shard=(0, 1),
               start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, global_batch, shard)
            step += 1
