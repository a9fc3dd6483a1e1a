"""Synthetic language-model token streams (no external datasets offline).

A Zipfian unigram model with Markov bigram structure gives a stream whose loss
actually *decreases* under training (unlike uniform noise), which the e2e
example uses to train a ~100M model for a few hundred steps.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class MarkovTokenStream:
    """z_t' ~ P(. | z_{t'-1}) with a sparse random bigram table over a Zipf
    unigram prior. Stateless draws per (seq, position) via counter-based RNG."""

    def __init__(self, vocab_size: int, branch: int = 32, alpha: float = 1.2,
                 seed: int = 0):
        self.V = vocab_size
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self.unigram = (ranks ** -alpha)
        self.unigram /= self.unigram.sum()
        # each token transitions to `branch` successors (hash-based, O(1) memory)
        self._a = rng.integers(1, 2**31 - 1)
        self._b = rng.integers(1, 2**31 - 1)
        self.branch = branch
        self._seed = seed

    def _succ(self, tok: np.ndarray, j: np.ndarray) -> np.ndarray:
        return ((tok * self._a + j * self._b + 12345) % (2**31 - 1)) % self.V

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        toks = np.empty((batch, seq), dtype=np.int32)
        toks[:, 0] = rng.choice(self.V, size=batch, p=self.unigram)
        js = rng.integers(0, self.branch, size=(batch, seq))
        for t in range(1, seq):
            toks[:, t] = self._succ(toks[:, t - 1], js[:, t])
        return toks

    def batches(self, batch: int, seq: int, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        while True:
            toks = self.sample(rng, batch, seq + 1)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
