"""Token sampling: temperature / top-k / top-p, drawn from a generator
(:func:`sample_logits`), the per-request batched sampler of the continuous
engine (:func:`sample_logits_batched`) and the exact-match verification of
its speculative windows (:func:`speculative_verify`)."""

from __future__ import annotations

import numpy as np
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


def speculative_verify(logits: torch.Tensor, drafts: torch.Tensor, seeds,
                       counts, greedy_first, temperature, top_k, top_p, *,
                       uniforms: torch.Tensor | None = None,
                       use_top_k: bool = True, use_top_p: bool = True):
    """Exact-match accept / reject and the bonus draw of a draft-and-verify
    window.

    ``logits`` [B, k+1, V] are the target's scores of the window
    ``[last token, d_1 .. d_k]``; ``drafts`` [k, B] the proposals ``d_1 ..
    d_k``. ``seeds``, ``counts`` and ``greedy_first`` [B] (host ints) are
    each row's seed, token count and greedy horizon as the non-speculative
    loop carries them; ``temperature``, ``top_p`` [B] fp32 and ``top_k``
    [B] int (host arrays) its filters.

    Column ``i`` draws what the non-speculative loop would draw at token
    count ``counts + i``: the same :func:`sample_logits_batched` over the
    flattened ``(k+1)·B`` rows, each sampled row's noise from
    :func:`request_uniforms` at ``(seed, count + i)``, greedy where ``count
    + i < greedy_first`` or the temperature is 0 (no noise is drawn there).
    ``d_{i+1}`` is accepted iff it equals column ``i``'s draw and every
    earlier draft was accepted; a column's draw is consumed only then, when
    the window's prefix is the non-speculative history, so the emitted
    ``target[0 .. n_acc]`` are the non-speculative tokens, the last one the
    bonus draw at the first rejected (or the window's last) position.

    With ``counts`` a tensor, every per-row argument is a [B] tensor on
    the logits' device (``seeds`` is not read) and ``uniforms`` [k+1, B,
    V] holds the noise of column ``i`` of row ``b`` at ``[i, b]``, drawn by
    the caller from the same ``request_uniforms(seed, count + i)``, or is
    None when no column samples: the form of a step body, which neither
    reads nor uploads host data. The draws are the same bits.

    Returns ``(target [k+1, B] int64, n_acc [B] int64)``: emit ``n_acc +
    1`` tokens a row.
    """
    b, kp1, v = logits.shape
    dev = logits.device
    if not isinstance(counts, torch.Tensor):
        # host arrays: the noise of each sampled column is drawn here
        cnt = (np.asarray(counts, np.int64)[None, :]
               + np.arange(kp1, dtype=np.int64)[:, None])
        greedy = (cnt < np.asarray(greedy_first, np.int64)) | (
            np.asarray(temperature, np.float32) <= 0.0)
        noisy = np.flatnonzero(~greedy.reshape(-1))
        uniforms = None
        if len(noisy):
            seed = np.tile(np.asarray(seeds, np.int64), kp1)
            uniforms = torch.full((kp1 * b, v), 0.5, device=dev)
            uniforms[torch.as_tensor(noisy, device=dev)] = request_uniforms(
                seed[noisy], cnt.reshape(-1)[noisy], v, dev)
        counts, greedy_first, top_k = (
            torch.as_tensor(np.asarray(a, np.int64), device=dev)
            for a in (counts, greedy_first, top_k))
        temperature, top_p = (
            torch.as_tensor(np.asarray(a, np.float32), device=dev)
            for a in (temperature, top_p))
    cnt = counts[None, :] + torch.arange(kp1, device=dev)[:, None]
    temp = temperature.repeat(kp1)
    greedy = (cnt.reshape(-1) < greedy_first.repeat(kp1)) | (temp <= 0.0)
    flat = logits.transpose(0, 1).reshape(kp1 * b, v)
    target = sample_logits_batched(
        flat, temp, top_k.repeat(kp1), top_p.repeat(kp1), greedy,
        None if uniforms is None else uniforms.reshape(kp1 * b, v),
        use_top_k=use_top_k, use_top_p=use_top_p).reshape(kp1, b)
    if kp1 == 1:
        return target, torch.zeros(b, dtype=torch.int64, device=dev)
    match = (drafts.to(target.dtype) == target[:-1]).long()       # [k, B]
    return target, torch.cumprod(match, dim=0).sum(dim=0)
