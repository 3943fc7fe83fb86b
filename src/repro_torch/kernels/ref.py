"""Plain PyTorch versions of the hand-written kernels in this package.

Each function computes what its CUDA kernel computes, in the reference's
op order, and is what a kernel wrapper runs for a tensor on the CPU. On the
card ``chip_smoke.py`` holds every kernel against these functions.

Quantizers are reciprocal-free: ``round(v * (q / range))``, never
``round(v / (range / q))``. PyTorch evaluates ``python_scalar / tensor`` as
``tensor.reciprocal() * scalar`` (and, on CUDA, ``tensor / python_scalar``
as a multiply by the scalar's reciprocal), which moves values that sit on a
rounding boundary. On the RTN lattice those values are systematic, so every
scalar division here goes through :func:`rdiv` / :func:`div`, which are true
IEEE divisions of two tensors on every device.
"""

from __future__ import annotations

import torch


def qmax(bits: int) -> float:
    """Largest positive level of a symmetric ``bits``-bit quantizer."""
    return float(2 ** (bits - 1) - 1)


def rdiv(q: float, t: torch.Tensor) -> torch.Tensor:
    """``q / t`` as an IEEE division (not ``t.reciprocal() * q``)."""
    return torch.div(torch.full_like(t, q), t)


def div(t: torch.Tensor, q: float) -> torch.Tensor:
    """``t / q`` as an IEEE division (not ``t * (1 / q)``)."""
    return torch.div(t, torch.full_like(t, q))


def clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``jnp.clip`` with tensor bounds: ``min(max(x, lo), hi)``."""
    return torch.minimum(torch.maximum(x, lo), hi)


# Deterministic ADC tie-break, shared by every implementation of eq. (2)
# (``core.quant.output_quantize``, this file, the CUDA kernel's epilogue).
# RTN-lattice arithmetic puts accumulator values exactly on round-half
# boundaries, where a 1-ulp accumulation-order difference flips a whole ADC
# level. Scaling the rounding operand by (1 - 2^-16) moves the decision
# boundary strictly between lattice points, so implementations agree while
# their accumulations differ by much less than 2^-16 relative.
ADC_TIE_BREAK = 1.0 - 2.0 ** -16


def round_up(v: int, mult: int) -> int:
    """Round ``v`` up to a multiple of ``mult``."""
    return ((v + mult - 1) // mult) * mult


def adc_bound(w_eff: torch.Tensor, beta: torch.Tensor,
              lam: float) -> torch.Tensor:
    """Per-column ADC bound of eq. (2): ``lam * beta * max|W[:, i]|`` [N]."""
    col_max = torch.amax(torch.abs(w_eff.float()), dim=0)
    return lam * beta.float() * col_max


def analog_matmul_ref(x: torch.Tensor, w_eff: torch.Tensor,
                      beta: torch.Tensor, bound: torch.Tensor,
                      col_off: torch.Tensor | None = None, *,
                      in_bits: int = 8, out_bits: int = 8) -> torch.Tensor:
    """Plain version of the fused analog MVM.

    x [M, K], w_eff [K, N] (already noise-perturbed), beta scalar static
    input range (eq. 1), bound [N] per-column ADC bound (eq. 2), col_off [N]
    optional per-column offset added before the ADC. Returns [M, N] in
    ``x.dtype``.
    """
    xf = x.float()
    qi = qmax(in_bits)
    beta = torch.clamp_min(beta.float(), 1e-8)
    x_q = div(beta, qi) * torch.round(clip(xf, -beta, beta) * rdiv(qi, beta))

    y = torch.matmul(x_q, w_eff.float())
    if col_off is not None:
        y = y + col_off.float()[None, :]

    qo = qmax(out_bits)
    b = torch.clamp_min(bound.float(), 1e-8)[None, :]
    inv = rdiv(qo, b) * ADC_TIE_BREAK
    y_q = clip(div(b, qo) * torch.round(y * inv), -b, b)
    return y_q.to(x.dtype)


def unpack_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """[K, N//2] uint8 → [K, N] int32 in [-8, 7] (low nibble = column 2j)."""
    lo = (w_packed & 0x0F).to(torch.int32) - 8
    hi = (w_packed >> 4).to(torch.int32) - 8
    return torch.stack([lo, hi], dim=-1).reshape(w_packed.shape[0], -1)


def int4_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the packed-int4 matmul: ``x @ ((nib - 8) * scale)``.

    w_packed [K, N//2] uint8 holds column 2j in the low nibble and 2j+1 in
    the high nibble, each storing ``int4 + 8``; scale [N] per-column.
    """
    w = unpack_int4(w_packed).float() * scale.float()[None, :]
    return torch.matmul(x.float(), w).to(x.dtype)


def pack_int4(w_int: torch.Tensor) -> torch.Tensor:
    """Pack int4 values in an int8 carrier ([K, N], N even) to [K, N//2]."""
    u = (w_int.to(torch.int32) + 8).to(torch.uint8)
    return u[:, 0::2] | (u[:, 1::2] << 4)
