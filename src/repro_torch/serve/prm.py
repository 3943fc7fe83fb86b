"""Process-reward-model stand-in for the test-time-compute harness.

The paper (App. F / Fig. 4) scores MATH-500 candidates with a learned PRM.
At small scale the PRM is a *noisy oracle*: reward = sigmoid(noise +
margin·correctness). Its ``reliability`` sets how informative rewards are:
at 0.5 the PRM is uninformative and PRM selection degenerates to majority
voting. numpy only; the port's own copy of the JAX package's module, so the
same seeds give the same rewards.
"""

from __future__ import annotations

import numpy as np


class NoisyOraclePRM:
    """Noisy-oracle PRM: reward = sigmoid(noise + margin·correctness)."""

    def __init__(self, reliability: float = 0.75, seed: int = 0):
        """reliability ∈ [0.5, 1]: 0.5 = uninformative, 1 = oracle."""
        if not 0.0 <= reliability <= 1.0:
            raise ValueError(f"reliability must lie in [0, 1], got "
                             f"{reliability!r}")
        self.margin = 2.0 * (reliability - 0.5)
        self.rng = np.random.default_rng(seed)

    def score(self, answers: np.ndarray, correct: np.ndarray) -> np.ndarray:
        """answers [N], correct scalar/broadcast → rewards in (0, 1)."""
        is_right = (answers == correct).astype(np.float64)
        z = self.rng.normal(0.0, 1.0, size=answers.shape)
        return 1.0 / (1.0 + np.exp(-(z + 4.0 * self.margin
                                     * (is_right - 0.5))))


def select_answer(answers: np.ndarray, rewards: np.ndarray,
                  strategy: str) -> int:
    """Answer-selection strategies of App. F / Table 15.

    ``prm_greedy``: the answer with the single highest reward;
    ``prm_voting``: reward-weighted majority voting;
    ``voting``: plain majority voting.
    """
    if strategy == "prm_greedy":
        return int(answers[np.argmax(rewards)])
    uniq = np.unique(answers)
    if strategy == "prm_voting":
        scores = [rewards[answers == u].sum() for u in uniq]
    elif strategy == "voting":
        scores = [(answers == u).sum() for u in uniq]
    else:
        raise ValueError(strategy)
    return int(uniq[int(np.argmax(scores))])
