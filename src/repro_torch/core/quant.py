"""Quantization primitives for analog (AIMC) and digital low-precision
execution, with the straight-through (STE) gradients of hardware-aware
training.

The paper's eq. (1) static input (DAC) quantization, eq. (2) globally static
per-column output (ADC) quantization, and the fake-quant helpers of the
LLM-QAT and RTN baselines. Weights are stored ``[in, out]``, so per-channel
means per column (reduction over axis 0). All quantizers are symmetric.

Gradients are the reference's (``repro.core.quant``): ``round`` never gets
one (:func:`round_ste`); :func:`input_quantize` is a
``torch.autograd.Function`` with the clamp-STE input gradient and the LSQ
range gradient; :func:`output_quantize` is a pure STE with no bound
gradient; the ranges of :func:`weight_fake_quant` and
:func:`dynamic_input_quantize` are detached. The RTN and KV quantizers are
eval/serve-only.

Every division by a tensor goes through ``kernels.ref.rdiv`` / ``div`` (or
divides two tensors of one shape): PyTorch computes ``python_scalar /
tensor`` as ``tensor.reciprocal() * scalar``, which moves values that sit on
a rounding boundary (see ``repro_torch.kernels.ref``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import abs_max, clip, div, qmax, rdiv

__all__ = ["qmax", "round_ste", "input_quantize", "dynamic_input_quantize",
           "output_quantize", "weight_fake_quant", "rtn_quantize",
           "rtn_dequantize", "kv_quantize", "kv_dequantize",
           "ema_init_update", "range_decay_update"]


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with a straight-through gradient, in the
    reference's form ``x + stop_gradient(round(x) - x)`` (the value is
    ``round(x)`` exactly: ``round(x) - x`` is exact in fp32)."""
    return x + (torch.round(x) - x).detach()


def input_quantize_fwd(x: torch.Tensor, beta: torch.Tensor, bits: int):
    """eq. (1) without a gradient rule: ``(x_q, beta clamped at 1e-8)``
    (the forward of :func:`input_quantize`, which the fused MVM's
    backward replays)."""
    q = qmax(bits)
    beta = torch.clamp_min(beta, 1e-8)
    xq = div(beta, q) * torch.round(clip(x, -beta, beta) * rdiv(q, beta))
    return xq, beta


def input_quantize_grads(x: torch.Tensor, beta: torch.Tensor,
                         xq: torch.Tensor, g: torch.Tensor):
    """The reference's ``_input_quantize_bwd`` for an upstream ``g``:
    ``dx`` is ``g`` where ``|x| <= beta`` and 0 outside (clamp STE);
    ``dbeta`` is the LSQ ``sum(where(inside, (x_q - x) / beta, sign(x)) *
    g)`` (``beta`` clamped as in the forward; the quotient is a division of
    two tensors of ``x``'s shape, so no reciprocal stands in for it)."""
    inside = torch.abs(x) <= beta
    dx = torch.where(inside, g, torch.zeros_like(g)).to(x.dtype)
    err = torch.where(inside, torch.div(xq - x, beta.expand_as(x)),
                      torch.sign(x))
    return dx, torch.sum(err * g)


class _InputQuantize(torch.autograd.Function):
    """eq. (1) with the clamp-STE / LSQ gradients (see
    :func:`input_quantize_grads`)."""

    @staticmethod
    def forward(ctx, x, beta, bits):
        xq, beta_c = input_quantize_fwd(x, beta, bits)
        ctx.save_for_backward(x, beta_c, xq)
        ctx.beta_shape, ctx.beta_dtype = beta.shape, beta.dtype
        return xq

    @staticmethod
    def backward(ctx, g):
        x, beta_c, xq = ctx.saved_tensors
        dx, dbeta = input_quantize_grads(x, beta_c, xq, g)
        return dx, dbeta.to(ctx.beta_dtype).reshape(ctx.beta_shape), None


def input_quantize(x: torch.Tensor, beta: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """Static-range DAC fake quantization (eq. 1):
    ``beta/Q * round(clip(x, -beta, beta) * Q/beta)``, ``Q = 2^(b-1) - 1``.

    Gradients (the reference's custom rule, LSQ-style): ``x`` passes
    inside ``[-beta, beta]`` and gets 0 outside; ``beta`` gets ``sign(x)``
    from clipped elements and ``(x_q - x) / beta`` from the others."""
    return _InputQuantize.apply(x, beta, bits)


def dynamic_input_quantize(x: torch.Tensor, bits: int,
                           axis: int = -1) -> torch.Tensor:
    """DI8-style dynamic per-token symmetric quantization (baseline only):
    the range is ``max|x|`` along ``axis``, detached; the rounding is an
    STE."""
    q = qmax(bits)
    beta = torch.clamp_min(
        torch.amax(torch.abs(x), dim=axis, keepdim=True).detach(), 1e-8)
    scale = div(beta, q)
    return scale * round_ste(torch.div(clip(x, -beta, beta), scale))


class _OutputQuantize(torch.autograd.Function):
    """eq. (2) with a pure straight-through backward: ``dy = g``, no bound
    gradient (the bound is derived, not trained)."""

    @staticmethod
    def forward(ctx, y, bound, bits):
        q = qmax(bits)
        bound = torch.clamp_min(bound, 1e-8)
        inv = rdiv(q, bound) * ref.ADC_TIE_BREAK
        return clip(div(bound, q) * torch.round(y * inv), -bound, bound)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def output_quantize(y: torch.Tensor, bound: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """Per-column ADC quantization (eq. 2) with the shared tie-break:
    ``clip(bound/Q * round(y * (Q/bound) * TIE), -bound, bound)``; its
    gradient passes ``y``'s through untouched (the paper's simple STE)."""
    return _OutputQuantize.apply(y, bound, bits)


def weight_fake_quant(w: torch.Tensor, bits: int,
                      axis: int = 0) -> torch.Tensor:
    """Per-channel symmetric weight fake quantization (LLM-QAT W4): ranges
    ``max|w|`` along ``axis``, detached; the rounding is an STE."""
    q = qmax(bits)
    beta = torch.clamp_min(
        torch.amax(torch.abs(w), dim=axis, keepdim=True).detach(), 1e-12)
    scale = div(beta, q)
    return scale * round_ste(torch.div(clip(w, -beta, beta), scale))


def rtn_quantize(w: torch.Tensor, bits: int, axis: int = 0):
    """Round-to-nearest PTQ: ``(w_int int8 in [-Q, Q], scale)`` with
    per-channel scales (keepdim along ``axis``)."""
    q = qmax(bits)
    beta = torch.clamp_min(abs_max(w, axis, keepdim=True), 1e-12)
    scale = div(beta, q)
    # in place after the one product: a leaf's temporaries stay one copy
    w_int = (w * rdiv(q, beta)).round_().clamp_(-q, q)
    return w_int.to(torch.int8), scale


def rtn_dequantize(w_int: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """Dequantize an RTN int carrier back to ``w_int * scale``."""
    return w_int.to(dtype).mul_(scale.to(dtype))


# ---------------------------------------------------------------------------
# KV-cache quantization (the int8 paged pool, serving only)
# ---------------------------------------------------------------------------

def kv_quantize(x: torch.Tensor, bits: int = 8):
    """Symmetric per-vector quantization for KV-cache storage.

    ``x`` [..., hd] holds one K or V head vector per leading index; the
    scale is the absmax over the head dim, so each cached token/head pair
    carries its own scale. Returns ``(x_int8, scale)`` with ``scale`` of
    shape ``x.shape[:-1]`` (fp32). Both divisions are true IEEE divisions
    (``ref.div``), so the CPU and the card round alike.
    """
    q = qmax(bits)
    xf = x.float()
    absmax = torch.amax(torch.abs(xf), dim=-1)
    scale = div(torch.clamp_min(absmax, 1e-8), q)
    x_int = torch.clamp(torch.round(torch.div(xf, scale[..., None])), -q, q)
    return x_int.to(torch.int8), scale


def kv_dequantize(x_int: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Invert :func:`kv_quantize`: ``x_int * scale`` with broadcast scales."""
    return (x_int.float() * scale.float()[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# input-range state (EMA init phase, then the decay rule)
# ---------------------------------------------------------------------------

def ema_init_update(beta: torch.Tensor, x_std: torch.Tensor, step: int,
                    kappa: float, init_steps: int,
                    ema: float = 0.9) -> torch.Tensor:
    """Input-range update of the first ``init_steps`` steps (§3.1, App.
    D): ``kappa * std(x)`` at step 0, then an EMA towards it; unchanged
    after. ``step`` is the host's step count."""
    step = int(step)
    if step >= init_steps:
        return beta
    target = kappa * x_std
    if step == 0:
        return target
    return ema * beta + (1.0 - ema) * target


def range_decay_update(beta: torch.Tensor, clip_fraction: torch.Tensor,
                       step: int, decay: float, input_min_percentage: float,
                       init_steps: int) -> torch.Tensor:
    """Post-init multiplicative decay favouring tight ranges
    (AIHWKIT-Lightning): ``beta * (1 - decay)`` where less than ``1 -
    input_min_percentage`` of the inputs clipped, from step ``init_steps``
    on."""
    if int(step) < init_steps:
        return beta
    should_decay = clip_fraction < (1.0 - input_min_percentage)
    return beta * torch.where(should_decay, torch.full_like(beta, 1.0 - decay),
                              torch.ones_like(beta))
