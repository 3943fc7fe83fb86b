"""Weight-noise models: training-time injection (paper eqs. 3/5) and the
hardware-realistic PCM programming-noise model (paper Appendix E.3).

All noise is per output channel scaled: with weights stored ``[in, out]``,
channel statistics reduce over ``axis=0`` (the crossbar column). Every
sampler takes an explicit ``torch.Generator`` on the weights' device; its
numbers differ from JAX's, so the tests compare distributions, or hand both
packages one instance drawn by the reference.
"""

from __future__ import annotations

import torch


def channel_absmax(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Per-output-channel absolute max |W|, floored at 1e-12 (keepdim)."""
    return torch.clamp_min(torch.amax(torch.abs(w), dim=axis, keepdim=True),
                           1e-12)


def _normal(gen: torch.Generator, w: torch.Tensor) -> torch.Tensor:
    """Standard normal fp32 draws shaped like ``w`` on its device."""
    return torch.randn(w.shape, generator=gen, device=w.device,
                       dtype=torch.float32)


def gaussian_weight_noise(gen: torch.Generator, w: torch.Tensor,
                          gamma: float, beta_mult: float = 0.0,
                          axis: int = 0) -> torch.Tensor:
    """Additive training-noise term of eq. (5) (eq. (3) when
    ``beta_mult == 0``): ``(gamma * max|W_col| + beta_mult * |W|) * tau``."""
    sigma = gamma * channel_absmax(w, axis=axis)
    if beta_mult:
        sigma = sigma + beta_mult * torch.abs(w)
    return (sigma * _normal(gen, w)).to(w.dtype)


#: third-degree polynomial fitted to the 64-core PCM chip's programming
#: error: sigma in percent of the per-channel max weight as a function of the
#: weight magnitude in percent of that max. sigma(0) = 2.11% is the additive
#: floor; an exact zero weight is noiseless.
_PCM_COEFFS = (1.23e-5, -3.06e-3, 2.45e-1, 2.11)


def pcm_hermes_sigma(w_pct: torch.Tensor) -> torch.Tensor:
    """sigma (% of channel max) for weights ``w_pct`` in [0, 100] (% of max)."""
    a3, a2, a1, a0 = _PCM_COEFFS
    return ((a3 * w_pct + a2) * w_pct + a1) * w_pct + a0


def pcm_hermes_noise(gen: torch.Generator, w: torch.Tensor,
                     axis: int = 0) -> torch.Tensor:
    """Sample hardware-realistic PCM programming noise for ``w`` (eval only).
    Exact zeros stay noiseless."""
    wmax = channel_absmax(w, axis=axis)
    w_pct = torch.div(100.0 * torch.abs(w.float()), wmax)
    sigma = pcm_hermes_sigma(w_pct) / 100.0 * wmax
    noise = torch.where(w == 0, torch.zeros_like(sigma),
                        sigma * _normal(gen, w))
    return noise.to(w.dtype)


def validate_noise_config(model: str, gamma: float = 0.0) -> None:
    """Reject meaningless eval-noise settings: unknown models, ``gamma < 0``,
    and ``model="gaussian"`` at ``gamma == 0`` (a placebo)."""
    if model not in ("none", "hw", "gaussian"):
        raise ValueError(f"unknown eval noise model: {model!r}")
    if gamma < 0:
        raise ValueError(f"eval noise gamma must be >= 0, got {gamma!r}")
    if model == "gaussian" and gamma == 0:
        raise ValueError(
            "model='gaussian' with gamma == 0 is a placebo (no perturbation "
            "would be applied); use model='none' for a noiseless run or set "
            "gamma > 0")


def apply_eval_noise(gen: torch.Generator, w: torch.Tensor, model: str,
                     gamma: float = 0.0, axis: int = 0) -> torch.Tensor:
    """Perturb weights for a noisy evaluation: ``"none"``, ``"hw"`` (PCM
    Hermes) or ``"gaussian"`` (per-channel-max additive at ``gamma``)."""
    validate_noise_config(model, gamma)
    if model == "none":
        return w
    if model == "hw":
        return w + pcm_hermes_noise(gen, w, axis=axis)
    return w + gaussian_weight_noise(gen, w, gamma, axis=axis)


def sample_noise_instance(gen: torch.Generator, w: torch.Tensor, model: str,
                          axis: int = 0) -> torch.Tensor:
    """One deployment's unit noise instance for ``w``: the absolute PCM
    perturbation for ``"hw"``, ``channel_absmax * tau`` for ``"gaussian"``
    (callers scale it by gamma)."""
    if model == "hw":
        return pcm_hermes_noise(gen, w, axis=axis)
    if model == "gaussian":
        return (channel_absmax(w, axis=axis) * _normal(gen, w)).to(w.dtype)
    raise ValueError(f"no noise instance for model {model!r}")
