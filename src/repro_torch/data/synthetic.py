"""Synthetic data generation, stage 1 of the paper's pipeline (Fig. 2a).

Sequences are sampled from the *teacher model itself*, starting from the
BOS token and continuing past EOS, chunked to the training sequence length
(App. B.1). Three strategies:

* ``sss``: every token from the softmax distribution (the paper's best);
* ``rgs``: random first token, next 5 greedy, rest softmax;
* ``sgs``: softmax first token, next 5 greedy, rest softmax.

Top-50 truncation mirrors the Llama-3.2 setting; ``filter_low_logprob``
implements the optional bottom-20% log-prob filtering ablation. Generation
runs where ``params`` live, on the static decode loop
(``serve.decode.generate``), with its draws from an explicit generator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.analog import AnalogConfig, AnalogCtx
from repro_torch.models.model import apply as model_apply
from repro_torch.serve.decode import generate


@dataclasses.dataclass(frozen=True)
class GenConfig:
    """Synthetic-generation settings (strategy sss/rgs/sgs, App. B.1)."""
    strategy: str = "sss"           # sss | rgs | sgs
    temperature: float = 1.0
    top_k: int = 50
    bos_token: int = 1


def generate_synthetic(params, cfg, generator: torch.Generator,
                       num_seqs: int, seq_len: int,
                       gen: GenConfig = GenConfig(),
                       batch_size: int = 16) -> np.ndarray:
    """Sample ``num_seqs`` sequences of ``seq_len`` tokens from the teacher
    (``generator`` lives on the params' device)."""
    acfg = AnalogConfig(mode="off")
    device = params["embed"]["tokens"].device
    chunks = []
    done = 0
    while done < num_seqs:
        b = min(batch_size, num_seqs - done)
        if gen.strategy == "rgs":
            first = torch.randint(0, cfg.vocab_size, (b, 1),
                                  generator=generator, device=device)
            greedy_first = 5
        else:
            first = torch.full((b, 1), gen.bos_token, dtype=torch.int64,
                               device=device)
            greedy_first = 5 if gen.strategy == "sgs" else 0
        toks = generate(params, cfg, acfg, generator, first, seq_len - 1,
                        temperature=gen.temperature, top_k=gen.top_k,
                        greedy_first=greedy_first)
        chunks.append(torch.cat([first, toks], dim=1).cpu().numpy())
        done += b
    return np.concatenate(chunks, axis=0)[:num_seqs].astype(np.int32)


@torch.no_grad()
def teacher_logits(params, cfg, tokens,
                   extra_inputs: Optional[dict] = None) -> torch.Tensor:
    """Teacher forward for distillation targets (FP, no noise). ``tokens``
    (a tensor or an array) go to the params' device."""
    tokens = torch.as_tensor(tokens, dtype=torch.int64, device=next(
        iter(params["embed"].values())).device)
    inputs = {"tokens": tokens, **(extra_inputs or {})}
    logits, _, _ = model_apply(params, cfg, AnalogConfig(mode="off"),
                               AnalogCtx(), inputs)
    return logits


def filter_low_logprob(params, cfg, tokens: np.ndarray,
                       drop_fraction: float = 0.2,
                       batch_size: int = 16) -> np.ndarray:
    """Drop the lowest-log-prob sequences (App. B.1 filtering ablation)."""
    scores = []
    for i in range(0, len(tokens), batch_size):
        tb = torch.as_tensor(tokens[i:i + batch_size], dtype=torch.int64,
                             device=params["embed"]["tokens"].device)
        lp = torch.log_softmax(teacher_logits(params, cfg, tb[:, :-1]),
                               dim=-1)
        ll = torch.gather(lp, -1, tb[:, 1:, None])[..., 0]
        scores.append(torch.mean(ll, dim=1).cpu().numpy())
    scores = np.concatenate(scores)
    keep = scores.argsort()[int(drop_fraction * len(tokens)):]
    return tokens[np.sort(keep)]
