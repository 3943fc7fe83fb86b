"""Iterative weight clipping (paper eq. 4).

After every optimizer step each output channel of every analog weight is
clamped to ``±alpha · std(channel)``. The paper's ablation (App. C.3,
Table 13) finds this worth more robustness than noise injection; it also
drives the weight distribution towards uniform (Fig. 6), which is why the
same models quantize well with plain RTN (Table 3).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import clip


def clip_weight(w: torch.Tensor, alpha: float, axis: int = 0) -> torch.Tensor:
    """Per-channel clamp to ``alpha`` population standard deviations taken
    along ``axis`` (eq. 4)."""
    std = torch.std(w.float(), dim=axis, keepdim=True, correction=0)
    zeta = (alpha * std).to(w.dtype)
    return clip(w, -zeta, zeta)


def clip_tree(params: dict, labels: dict, alpha: float) -> dict:
    """Apply eq. (4) to every ``"analog_weight"`` leaf; other leaves are
    shared. The channel axis is the last one and the std runs over axis -2,
    within a layer: 2-D ``[in, out]`` and stacked ``[L, in, out]`` alike."""
    def walk(p, lab):
        return {k: walk(v, lab[k]) if isinstance(v, dict)
                else clip_weight(v, alpha, axis=-2)
                if lab[k] == "analog_weight" else v
                for k, v in p.items()}

    return walk(params, labels)


def kurtosis(w: torch.Tensor) -> torch.Tensor:
    """Kurtosis (not excess) of a weight tensor, the Fig. 6b diagnostic."""
    w = w.float().reshape(-1)
    mu = torch.mean(w)
    var = torch.mean((w - mu) ** 2)
    return torch.div(torch.mean((w - mu) ** 4),
                     torch.clamp_min(var ** 2, 1e-12))
