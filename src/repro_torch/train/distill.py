"""Losses: knowledge distillation (the paper's training loss) and CE.

The paper trains analog foundation models with a pure distillation loss
(KL against the frozen teacher at temperature 2.0 / 1.0, beta 1.0); App. B.4
shows CE alone loses 8.05 % on average, because the student starts modelling
the synthetic data instead of imitating the teacher.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import div


def _masked_mean(v: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """``sum(v · mask) / max(sum(mask), 1)`` with ``mask`` broadcast to
    ``v``, or the plain mean."""
    if mask is None:
        return torch.mean(v)
    m = torch.broadcast_to(mask.float(), v.shape)
    return torch.div(torch.sum(v * m), torch.clamp_min(torch.sum(m), 1.0))


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float = 1.0,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """KL(teacher ‖ student) at ``temperature`` times ``t²``, averaged over
    the (masked) tokens; logits [B, S, V] (or [B, S, K, V])."""
    t = temperature
    s_scaled = div(student_logits.float(), t)
    t_scaled = div(teacher_logits.float(), t)
    sp = torch.log_softmax(s_scaled, dim=-1)
    tp = torch.softmax(t_scaled, dim=-1)
    tlogp = torch.log_softmax(t_scaled, dim=-1)
    kl = torch.sum(tp * (tlogp - sp), dim=-1) * (t * t)
    if mask is not None:
        while mask.dim() < kl.dim():
            mask = mask[..., None]
    return _masked_mean(kl, mask)


def ce_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Next-token cross entropy; labels [B, S] (or [B, S, K])."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(lp, -1, labels.long()[..., None])[..., 0]
    return -_masked_mean(ll, mask)


def shift_for_next_token(tokens: torch.Tensor):
    """``(inputs, labels, mask)`` for autoregressive training on raw
    tokens [B, S]."""
    inputs = tokens[:, :-1]
    labels = tokens[:, 1:]
    mask = torch.ones(labels.shape[:2], dtype=torch.float32,
                      device=tokens.device)
    return inputs, labels, mask
