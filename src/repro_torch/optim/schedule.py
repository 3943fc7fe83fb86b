"""LR schedule (paper App. D: polynomial decay after a linear warm-up of
ratio 0.016)."""

from __future__ import annotations

import torch


def polynomial_with_warmup(step, *, peak_lr: float, total_steps: int,
                           warmup_ratio: float = 0.016, power: float = 1.0,
                           end_lr: float = 0.0) -> torch.Tensor:
    """Linear warm-up, then polynomial decay to ``end_lr``; a 0-d fp32
    tensor on the CPU, computed in fp32 in the reference's op order."""
    f32 = torch.float32
    step = torch.as_tensor(step, dtype=f32).cpu()
    warmup = torch.clamp_min(
        torch.tensor(warmup_ratio * total_steps, dtype=f32), 1.0)
    warm = torch.div(peak_lr * step, warmup)
    frac = torch.clamp(torch.div(step - warmup, torch.clamp_min(
        total_steps - warmup, 1.0)), 0.0, 1.0)
    decay = end_lr + (peak_lr - end_lr) * (1.0 - frac) ** power
    return torch.where(step < warmup, warm, decay)
