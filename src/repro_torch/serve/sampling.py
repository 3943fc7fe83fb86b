"""Token sampling: temperature / top-k / top-p, drawn from a generator
(:func:`sample_logits`), and the per-request batched sampler of the
continuous engine (:func:`sample_logits_batched`)."""

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


def sample_logits_batched(logits: torch.Tensor, temperature: torch.Tensor,
                          top_k: torch.Tensor, top_p: torch.Tensor,
                          greedy: torch.Tensor,
                          uniforms: torch.Tensor | None = None, *,
                          use_top_k: bool = True,
                          use_top_p: bool = True) -> torch.Tensor:
    """Per-request sampling for the continuous engine: every row carries its
    own parameters as tensors, so one step serves requests with different
    ``temperature`` / ``top_k`` / ``top_p`` / greediness.

    logits [B, V]; temperature, top_p [B] fp32; top_k [B] int (0 = off);
    greedy [B] bool. Filtering follows the reference's order (top-k on the
    scaled logits, then top-p on what is left). The draw is a Gumbel-max
    over ``uniforms`` [B, V] in (0, 1), one row of noise per request that
    the caller derives from the request's seed and token count
    (:func:`request_uniforms`), so a request draws the same tokens solo or
    mid-batch. ``uniforms`` is None when the caller knows every row is
    greedy; then no noise is drawn.
    ``use_top_k`` / ``use_top_p`` drop the full-vocab sorts when no row
    filters (the filters are no-ops for ``top_k = 0`` / ``top_p = 1``).
    Returns [B] int64 ids.
    """
    v = logits.shape[-1]
    lf = logits.float()
    greedy_tok = torch.argmax(lf, dim=-1)
    pick_greedy = greedy | (temperature <= 0.0)
    if uniforms is None:
        return greedy_tok
    scaled = lf / torch.clamp_min(temperature, 1e-6)[:, None]
    neg = torch.full_like(scaled, -float("inf"))
    if use_top_k:
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        k_idx = torch.clamp(top_k.long() - 1, 0, v - 1)[:, None]
        kth = torch.gather(sorted_desc, -1, k_idx)
        k_on = ((top_k > 0) & (top_k < v))[:, None]
        scaled = torch.where(k_on & (scaled < kth), neg, scaled)
    if use_top_p:
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
        cut_idx = torch.clamp_max(
            torch.sum(cum < top_p[:, None], dim=-1, keepdim=True), v - 1)
        cutoff = torch.gather(sorted_desc, -1, cut_idx)
        p_on = (top_p < 1.0)[:, None]
        scaled = torch.where(p_on & (scaled < cutoff), neg, scaled)
    gumbel = -torch.log(-torch.log(uniforms.float()))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(pick_greedy, greedy_tok, sampled)


def request_uniforms(seeds, counts, vocab: int, device) -> torch.Tensor:
    """Noise rows [B, vocab] in (0, 1) for :func:`sample_logits_batched`:
    row ``i`` depends only on ``(seeds[i], counts[i])`` (a request's seed
    and the number of tokens it has sampled), drawn from its own
    ``torch.Generator``, so it is the same whichever batch the request
    rides in."""
    rows = []
    for seed, count in zip(seeds, counts):
        g = torch.Generator(device=device).manual_seed(
            (int(seed) * 1_000_003 + int(count)) % (2 ** 63))
        rows.append(torch.rand((vocab,), generator=g, device=device))
    u = torch.stack(rows)
    return torch.clamp(u, torch.finfo(u.dtype).tiny, 1.0 - 2.0 ** -24)
