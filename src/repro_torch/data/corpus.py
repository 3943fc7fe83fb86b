"""Structured synthetic corpus, the stand-in for FineWeb at small scale.

A random sparse Markov chain over the vocabulary (Zipfian unigram marginal,
low-entropy transitions) gives a corpus with learnable statistical
structure. This is the port's own copy of the JAX package's numpy-only
module: the same seed gives the same ``succ``, ``probs``, samples and
Bayes-optimal predictions bit for bit.
"""

from __future__ import annotations

import numpy as np


class MarkovCorpus:
    """Sparse seeded Markov chain with Zipfian marginals (see module doc)."""

    def __init__(self, vocab_size: int, *, branching: int = 8,
                 zipf_a: float = 1.2, seed: int = 0):
        """Build the chain: ``branching`` successors per state,
        Zipf(zipf_a)."""
        rng = np.random.default_rng(seed)
        self.vocab_size = vocab_size
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        pop = ranks ** -zipf_a
        pop /= pop.sum()
        self.succ = rng.choice(vocab_size, size=(vocab_size, branching),
                               p=pop)
        self.probs = rng.dirichlet(np.full(branching, 0.5), size=vocab_size)
        self._rng = rng

    def sample(self, num_seqs: int, seq_len: int,
               seed: int | None = None) -> np.ndarray:
        """Sample [num_seqs, seq_len] token sequences from the chain."""
        rng = np.random.default_rng(seed) if seed is not None else self._rng
        out = np.empty((num_seqs, seq_len), np.int32)
        state = rng.integers(0, self.vocab_size, size=num_seqs)
        for t in range(seq_len):
            out[:, t] = state
            # vectorized categorical over each state's successor distribution
            u = rng.random(num_seqs)
            cdf = np.cumsum(self.probs[state], axis=1)
            idx = (u[:, None] < cdf).argmax(axis=1)
            state = self.succ[state, idx]
        return out

    def optimal_next_token(self, tokens: np.ndarray) -> np.ndarray:
        """Bayes-optimal next-token prediction (per-position argmax)."""
        best = self.succ[np.arange(self.vocab_size),
                         self.probs.argmax(axis=1)]
        return best[tokens]
