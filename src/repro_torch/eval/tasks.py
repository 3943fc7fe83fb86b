"""Synthetic evaluation tasks, small-scale stand-ins for the paper's
benchmark suite (MMLU-style logit comparison, GSM8K-style answers).

Each task returns a closure ``task(params, cfg, acfg) -> accuracy`` so that
the noisy-eval harness can re-run it across weight-perturbation seeds. The
closure runs its forward where ``params`` live: its tokens go to the
device of the embedding table.

* ``markov_next``: next-token logit-comparison accuracy against the
  Bayes-optimal prediction of the generating chain (MMLU/ARC stand-in).
* ``induction_copy``: in-context copying (A … A pattern), the in-context
  mechanism that degrades first under weight noise (GSM8K/ANLI stand-in).
* ``mod_add``: the generative answer task of the test-time-compute harness
  (MATH-500 stand-in): prompts, training sequences and answer extraction.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.analog import AnalogCtx
from repro_torch.models.model import apply as model_apply


def _device(params) -> torch.device:
    return params["embed"]["tokens"].device


@torch.no_grad()
def _logits(params, cfg, acfg, toks: np.ndarray) -> torch.Tensor:
    """Eval forward of ``toks`` [B, S] on the params' device."""
    tokens = torch.as_tensor(toks, dtype=torch.int64, device=_device(params))
    logits, _, _ = model_apply(params, cfg, acfg, AnalogCtx(),
                               {"tokens": tokens})
    return logits


def _accuracy(pred: torch.Tensor, target: torch.Tensor) -> float:
    """The share of equal entries as the JAX package's ``jnp.mean`` of the
    booleans computes it, so that a run is the same float: the fp32 count
    times the fp32 reciprocal of the number of entries."""
    hits = torch.sum((pred == target).float())
    return float(hits * torch.tensor(1.0 / pred.numel(), device=hits.device))


def markov_next(corpus, *, num_seqs: int = 64, seq_len: int = 64,
                seed: int = 1234) -> Callable:
    """Logit-comparison task vs the corpus Bayes argmax (MMLU stand-in)."""
    toks = corpus.sample(num_seqs, seq_len, seed=seed)
    target = corpus.optimal_next_token(toks)          # Bayes argmax

    def task(params, cfg, acfg) -> float:
        pred = torch.argmax(_logits(params, cfg, acfg, toks), dim=-1)
        tgt = torch.as_tensor(target, dtype=torch.int64, device=pred.device)
        # skip the first few tokens (no context yet)
        return _accuracy(pred[:, 4:], tgt[:, 4:])
    return task


def induction_copy(vocab_size: int, *, num_seqs: int = 64,
                   pattern_len: int = 12, seed: int = 99) -> Callable:
    """In-context copying task ([pat, 0, pat]; GSM8K/ANLI stand-in)."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(2, vocab_size, size=(num_seqs, pattern_len))
    # [pat, 0, pat]: predict the second occurrence from the first
    toks = np.concatenate([pat, np.zeros((num_seqs, 1), np.int64), pat],
                          axis=1).astype(np.int32)

    def task(params, cfg, acfg) -> float:
        logits = _logits(params, cfg, acfg, toks)
        # positions predicting the repeated pattern (2nd copy, tokens 1..L-1)
        start = pattern_len + 1
        pred = torch.argmax(logits[:, start:start + pattern_len - 1], dim=-1)
        tgt = torch.as_tensor(toks[:, start + 1:start + pattern_len],
                              dtype=torch.int64, device=pred.device)
        return _accuracy(pred, tgt)
    return task


# ---------------------------------------------------------------------------
# answer extraction (task-level hooks for serve.engine.sample_candidates)
# ---------------------------------------------------------------------------

def extract_first_token(toks: np.ndarray) -> int:
    """Answer = first generated token (single-token answer tasks)."""
    return int(np.asarray(toks)[0])


def extract_before_stop(stop_id: int) -> Callable[[np.ndarray], int]:
    """Answer = token immediately preceding the first ``stop_id``.

    A generation shaped ``[...scratch..., answer, STOP, ...]`` reduces to
    ``answer``. Falls back to the last generated token when no stop token
    appears (generation hit ``max_new``) or the stop token came first.
    """
    def extract(toks: np.ndarray) -> int:
        toks = np.asarray(toks)
        hits = np.flatnonzero(toks == stop_id)
        if hits.size and hits[0] > 0:
            return int(toks[hits[0] - 1])
        return int(toks[-1])
    return extract


def mod_add_extraction(mod: int = 23) -> Callable[[np.ndarray], int]:
    """Task-level hook for ``mod_add``: the answer is the first generated
    token in the answer alphabet ``[0, mod)`` (later tokens are free-run
    continuation; the SEP token ``mod`` acts as a terminator when the
    request carries it in ``stop_tokens``)."""
    def extract(toks: np.ndarray) -> int:
        toks = np.asarray(toks)
        valid = np.flatnonzero(toks < mod)
        return int(toks[valid[0]]) if valid.size else int(toks[0])
    return extract


def make_mod_add_data(vocab_size: int, *, num: int = 128, mod: int = 23,
                      seed: int = 7):
    """Prompts ``[a, b, SEP]`` with answer ``(a + b) % mod`` (token id)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, mod, size=num)
    b = rng.integers(0, mod, size=num)
    sep = mod          # reserve token `mod` as separator
    prompts = np.stack([a, b, np.full(num, sep)], axis=1).astype(np.int32)
    answers = ((a + b) % mod).astype(np.int32)
    return prompts, answers


def mod_add_train_tokens(vocab_size: int, *, num: int = 4096, mod: int = 23,
                         seed: int = 11) -> np.ndarray:
    """Training sequences ``[a, b, SEP, ans]`` for the test-time-compute
    demo."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, mod, size=num)
    b = rng.integers(0, mod, size=num)
    ans = (a + b) % mod
    return np.stack([a, b, np.full(num, mod), ans], axis=1).astype(np.int32)
