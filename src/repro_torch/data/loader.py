"""Deterministic, resumable data loader.

Shuffles with a seeded permutation per epoch; the iterator state (epoch,
cursor) is part of the training checkpoint, so a restarted run consumes
exactly the batches the interrupted run would have. This is the port's own
copy of the JAX package's numpy-only module: the same tokens, batch size
and seed give the same batches, state and restore.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class TokenLoader:
    """Seeded-permutation batch iterator with checkpointable state."""
    def __init__(self, tokens: np.ndarray, batch_size: int, *, seed: int = 0,
                 microbatches: int = 1, drop_last: bool = True):
        """tokens [N, S...]: shuffled in batches of ``batch_size`` per epoch."""
        assert tokens.ndim >= 2
        self.tokens = tokens
        self.batch_size = batch_size
        self.microbatches = microbatches
        self.seed = seed
        self.epoch = 0
        self.cursor = 0
        self._perm = self._permutation(0)

    def _permutation(self, epoch: int) -> np.ndarray:
        """Deterministic per-epoch shuffle (seed ⊕ epoch hash)."""
        rng = np.random.default_rng(self.seed + 1315423911 * epoch)
        return rng.permutation(len(self.tokens))

    # -- checkpointable state ------------------------------------------------
    def state(self) -> dict:
        """Checkpointable iterator state (epoch, cursor, seed)."""
        return {"epoch": self.epoch, "cursor": self.cursor,
                "seed": self.seed}

    def restore(self, state: dict):
        """Resume exactly where ``state`` left off (rebuilds the perm)."""
        self.seed = state["seed"]
        self.epoch = state["epoch"]
        self.cursor = state["cursor"]
        self._perm = self._permutation(self.epoch)

    # -- iteration -------------------------------------------------------------
    def __iter__(self) -> Iterator[np.ndarray]:
        """Yield [B, ...] (or [microbatches, B/mb, ...]) batches forever."""
        while True:
            if self.cursor + self.batch_size > len(self.tokens):
                self.epoch += 1
                self.cursor = 0
                self._perm = self._permutation(self.epoch)
            idx = self._perm[self.cursor:self.cursor + self.batch_size]
            self.cursor += self.batch_size
            batch = self.tokens[idx]
            if self.microbatches > 1:
                mb = self.batch_size // self.microbatches
                batch = batch.reshape(self.microbatches, mb,
                                      *batch.shape[1:])
            yield batch
