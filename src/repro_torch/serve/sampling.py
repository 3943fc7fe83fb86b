"""Token sampling: temperature / top-k / top-p, drawn from a generator."""

from __future__ import annotations

import torch


def sample_logits(gen: torch.Generator | None, logits: torch.Tensor, *,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, greedy: bool = False) -> torch.Tensor:
    """Sample token ids [...] from logits [..., V] (int64).

    ``greedy`` or ``temperature == 0`` takes the argmax and draws nothing.
    ``gen`` must live on the logits' device.
    """
    if greedy or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    v = logits.shape[-1]
    if top_k and top_k < v:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -float("inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest set with cumulative probability >= top_p
        cutoff_idx = torch.clamp_max(
            torch.sum(cum < top_p, dim=-1, keepdim=True), v - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, -float("inf"))
    probs = torch.softmax(logits, dim=-1).reshape(-1, v)
    draws = torch.multinomial(probs, 1, generator=gen)
    return draws.reshape(logits.shape[:-1])
