"""Quantization primitives for analog (AIMC) and digital low-precision
execution, forward only (the STE autograd rules come with training).

The paper's eq. (1) static input (DAC) quantization, eq. (2) globally static
per-column output (ADC) quantization, and the fake-quant helpers of the
LLM-QAT and RTN baselines. Weights are stored ``[in, out]``, so per-channel
means per column (reduction over axis 0). All quantizers are symmetric.

Every division by a tensor goes through ``kernels.ref.rdiv`` / ``div``:
PyTorch computes ``python_scalar / tensor`` as ``tensor.reciprocal() *
scalar``, which moves values that sit on a rounding boundary (see
``repro_torch.kernels.ref``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import clip, div, qmax, rdiv

__all__ = ["qmax", "input_quantize", "dynamic_input_quantize",
           "output_quantize", "weight_fake_quant", "rtn_quantize",
           "rtn_dequantize", "kv_quantize", "kv_dequantize"]


def input_quantize(x: torch.Tensor, beta: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """Static-range DAC fake quantization (eq. 1):
    ``beta/Q * round(clip(x, -beta, beta) * Q/beta)``, ``Q = 2^(b-1) - 1``."""
    q = qmax(bits)
    beta = torch.clamp_min(beta, 1e-8)
    return div(beta, q) * torch.round(clip(x, -beta, beta) * rdiv(q, beta))


def dynamic_input_quantize(x: torch.Tensor, bits: int,
                           axis: int = -1) -> torch.Tensor:
    """DI8-style dynamic per-token symmetric quantization (baseline only):
    the range is ``max|x|`` along ``axis``."""
    q = qmax(bits)
    beta = torch.clamp_min(torch.amax(torch.abs(x), dim=axis, keepdim=True),
                           1e-8)
    scale = div(beta, q)
    return scale * torch.round(torch.div(clip(x, -beta, beta), scale))


def output_quantize(y: torch.Tensor, bound: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """Per-column ADC quantization (eq. 2) with the shared tie-break:
    ``clip(bound/Q * round(y * (Q/bound) * TIE), -bound, bound)``."""
    q = qmax(bits)
    bound = torch.clamp_min(bound, 1e-8)
    inv = rdiv(q, bound) * ref.ADC_TIE_BREAK
    return clip(div(bound, q) * torch.round(y * inv), -bound, bound)


def weight_fake_quant(w: torch.Tensor, bits: int,
                      axis: int = 0) -> torch.Tensor:
    """Per-channel symmetric weight fake quantization (LLM-QAT W4)."""
    q = qmax(bits)
    beta = torch.clamp_min(torch.amax(torch.abs(w), dim=axis, keepdim=True),
                           1e-12)
    scale = div(beta, q)
    return scale * torch.round(torch.div(clip(w, -beta, beta), scale))


def rtn_quantize(w: torch.Tensor, bits: int, axis: int = 0):
    """Round-to-nearest PTQ: ``(w_int int8 in [-Q, Q], scale)`` with
    per-channel scales (keepdim along ``axis``)."""
    q = qmax(bits)
    beta = torch.clamp_min(torch.amax(torch.abs(w), dim=axis, keepdim=True),
                           1e-12)
    scale = div(beta, q)
    w_int = torch.clamp(torch.round(w * rdiv(q, beta)), -q, q)
    return w_int.to(torch.int8), scale


def rtn_dequantize(w_int: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """Dequantize an RTN int carrier back to ``w_int * scale``."""
    return w_int.to(dtype) * scale.to(dtype)


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
