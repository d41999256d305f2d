"""Synthetic LM token pipeline: Zipf-distributed tokens with a Markov
backbone (so a ~100M model trained a few hundred steps shows a real loss
drop), plus the token-bigram graph-stream view that feeds the gLava data
statistics.

Port of ``src/repro/data/lm.py``: host-side numpy, copied as it is, so the
same seed gives the same tokens on both sides."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class MarkovTokens:
    """Order-1 Markov chain over a Zipf vocabulary."""

    def __init__(self, vocab: int, branch: int = 8, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.branch = branch
        # each token can transition to `branch` successors
        self.succ = rng.integers(0, vocab, (vocab, branch)).astype(np.int32)
        ranks = np.arange(1, branch + 1, dtype=np.float64)
        p = ranks ** -1.2
        self.p = (p / p.sum()).astype(np.float64)

    def batch(self, batch: int, seq: int, rng) -> np.ndarray:
        toks = np.empty((batch, seq), np.int32)
        cur = rng.integers(0, self.vocab, batch)
        toks[:, 0] = cur
        for t in range(1, seq):
            choice = rng.choice(self.branch, size=batch, p=self.p)
            cur = self.succ[cur, choice]
            toks[:, t] = cur
        return toks


def token_batches(
    vocab: int, batch: int, seq: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    gen = MarkovTokens(vocab, seed=seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        yield {"tokens": gen.batch(batch, seq + 1, rng)}


def bigram_stream(tokens: np.ndarray) -> Dict[str, np.ndarray]:
    """The token-bigram view of an LM batch AS a graph stream (src=t_i,
    dst=t_{i+1}) — what the data pipeline feeds into gLava for corpus
    statistics."""
    src = tokens[:, :-1].reshape(-1).astype(np.uint32)
    dst = tokens[:, 1:].reshape(-1).astype(np.uint32)
    return {"src": src, "dst": dst, "weight": np.ones(len(src), np.float32)}
