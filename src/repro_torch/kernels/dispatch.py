"""Kernel-dispatch layer: routes ``analog_linear``'s MVM onto the
hand-written CUDA kernels when :attr:`AnalogConfig.use_pallas` is set.

Dispatch rules (the reference's ``kernels/dispatch.py``):

* ``analog`` / ``rtn`` modes with output quantization → :func:`analog_mvm`,
  one AIMC tile op (DAC-quant → MVM → per-column ADC-quant) fused in
  ``analog_matmul``. The weight handed in is the effective one (noise-
  perturbed or RTN-dequantized), so the kernel stays deterministic.
* ``rtn`` serving with 4-bit weights (``AnalogConfig.int4_serve``) →
  :func:`int4_mvm_packed`: weights packed two per byte, unpacked on chip;
  input and output quantization stay in the digital periphery.
* Paged attention of the continuous engine → :func:`paged_decode_attention`
  (``paged_flash_decode``) for a decode step and
  :func:`paged_prefill_attention` (``paged_flash_prefill``) for a prefill
  chunk, both scoring the block pool in place.
* The Mamba-2 SSD of the ssm family → :func:`ssd` (``ssd_scan``), the
  JAX package's ``ops.ssd`` with ``mamba2._ssd_with_state``'s incoming
  and final state folded in. The JAX package runs its Pallas kernel only on
  a TPU and only when the chunk divides S (else its chunked jnp path with
  ``chunk = min(128, S)``), so its own engine's 32-token chunks never reach
  the kernel there; the port takes the kernel on the card for every S,
  ragged tails included. The function is the same; the chunking is the
  kernel's own.
* A CPU tensor runs each kernel's plain PyTorch version (the CPU tests); a
  CUDA tensor launches the kernel or raises. There is no switch that sends
  a CUDA tensor to the plain version: a caller that wants it calls ``ref``.

The kernels are strictly 2-D, so ``[B, S, K]`` activations are flattened
here. Each kernel's library picks its own tiling for the card from the
shape; :func:`select_blocks` reports it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _launch, ref
from repro_torch.kernels.analog_matmul import analog_matmul
from repro_torch.kernels.int4_matmul import int4_matmul
from repro_torch.kernels.paged_attention import paged_flash_decode
from repro_torch.kernels.paged_prefill import paged_flash_prefill
from repro_torch.kernels.ssd_scan import ssd_scan


def use_fused(cfg) -> bool:
    """True when ``analog_linear`` should route through the fused tile op:
    ``use_pallas`` on, output quantization on, mode ``analog`` or ``rtn``."""
    return bool(cfg.use_pallas and cfg.output_quant
                and cfg.mode in ("analog", "rtn"))


def select_blocks(m: int, k: int, n: int, *, kernel: str = "analog_matmul",
                  device=None, in_bits: int = 8) -> _launch.Plan:
    """The plan ``kernel`` (``"analog_matmul"`` or ``"int4_matmul"``) runs
    for an [M, K] @ [K, N] call on the card: the GEMV-shaped decode mapping
    for M ≤ 8, else the tensor-core ``mma`` one (``analog_matmul`` with
    ``in_bits`` > 12: the CUDA-core ``tiled`` one), the split of K over
    blocks and the scratch. The CUDA library computes it (this card's SM
    count), so it needs the card."""
    index = torch.device("cuda" if device is None else device).index
    if index is None:
        index = torch.cuda.current_device()
    return _launch.plan(kernel, m, k, n, index,
                        in_bits if kernel == "analog_matmul" else None)


def flatten_batch(x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, ...]]:
    """[..., K] → (contiguous [M, K], leading shape)."""
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, x.shape[-1]).contiguous(), lead


def analog_mvm(x: torch.Tensor, w_eff: torch.Tensor, beta: torch.Tensor,
               bound: torch.Tensor | None = None, *,
               lam: float | None = None, in_bits: int = 8, out_bits: int = 8,
               col_off: torch.Tensor | None = None) -> torch.Tensor:
    """Fused DAC-quant → MVM → ADC-quant over any leading batch dims.

    Exactly one of ``bound`` [N] (an explicit ADC bound, as a calibration
    on other weights gives) and ``lam`` (the bound ``lam · β ·
    max|w_eff[:, n]|`` folded into the kernel's pass over ``w_eff``).
    ``col_off`` [N] is the optional per-column pre-ADC offset. No autograd
    rule; see :func:`fused_analog_mvm`.
    """
    x2, lead = flatten_batch(x.float())
    n = w_eff.shape[-1]
    y = analog_matmul(x2, w_eff.float().contiguous(), beta.float(),
                      None if bound is None else bound.float().contiguous(),
                      col_off, lam=lam, in_bits=in_bits, out_bits=out_bits)
    return y.reshape(*lead, n)


def fused_analog_mvm(x: torch.Tensor, w: torch.Tensor,
                     w_noise: torch.Tensor | None, beta: torch.Tensor,
                     bound: torch.Tensor | None = None, *,
                     lam: float | None = None, in_bits: int = 8,
                     out_bits: int = 8) -> torch.Tensor:
    """Fused analog MVM on ``w + w_noise`` (``w_noise`` None at eval, which
    spares a copy of the weights), against ``bound`` or the bound folded
    with ``lam`` (see :func:`analog_mvm`). ``lam`` is refused with a
    ``w_noise``: the fold would take the bound from ``w + w_noise``, where
    the reference takes it from the noise-free ``w``, so training on ``w +
    w_noise`` passes an explicit bound. Forward only: the autograd rule
    (fused forward, unfused STE backward) belongs to the training port, so
    a tensor that needs a gradient is refused."""
    if lam is not None and w_noise is not None:
        raise ValueError("fused_analog_mvm cannot fold the ADC bound from "
                         "noisy weights: pass the bound of the noise-free "
                         "weights (ref.adc_bound(w, beta, lam)) with w_noise")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w, w_noise, beta, bound)):
        raise NotImplementedError(
            "fused_analog_mvm is forward-only: its STE backward is not "
            "ported yet (run under torch.no_grad() or detach the inputs)")
    w_eff = w if w_noise is None else w + w_noise
    return analog_mvm(x, w_eff, beta, bound, lam=lam, in_bits=in_bits,
                      out_bits=out_bits)


def can_use_int4(out_dim: int, weight_bits: int) -> bool:
    """Packing is two nibbles per byte: needs 4-bit weights and even N."""
    return weight_bits == 4 and out_dim % 2 == 0


def int4_mvm_packed(x_q: torch.Tensor, w_packed: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """``x_q @ dequant(w_packed, scale)`` on the packed-int4 kernel.

    ``x_q`` is already DAC-quantized; ``w_packed`` [K, N//2] holds two int4
    nibbles per byte (``core.analog.pack_int4_weights``); ``scale`` the
    per-column dequant scales [N]. The caller applies output quantization.
    """
    x2, lead = flatten_batch(x_q.float())
    n = w_packed.shape[-1] * 2
    y = int4_matmul(x2, w_packed.contiguous(),
                    scale.reshape(-1).float().contiguous())
    return y.reshape(*lead, n)


def int4_mvm(x_q: torch.Tensor, w_int: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """:func:`int4_mvm_packed` with on-the-fly packing of the int8-carrier
    RTN output ``w_int`` [K, N] (N even)."""
    return int4_mvm_packed(x_q, ref.pack_int4(w_int), scale)


def paged_decode_attention(q: torch.Tensor, kp: torch.Tensor,
                           vp: torch.Tensor, tbl: torch.Tensor,
                           pos: torch.Tensor, start: torch.Tensor,
                           scale: float, *,
                           k_scale: torch.Tensor | None = None,
                           v_scale: torch.Tensor | None = None,
                           num_splits: int = 1) -> torch.Tensor:
    """One paged GQA decode step: q [B, H, hd] against the block pool
    ``kp`` / ``vp`` [P, bs, KV, hd] through ``tbl`` [B, NB]; row ``b``
    attends ``start[b] <= j <= pos[b]``. ``num_splits`` > 1 splits each
    row's block loop over thread blocks (merged in split order)."""
    return paged_flash_decode(q.contiguous(), kp, vp, tbl, pos, start,
                              scale=scale, k_scale=k_scale, v_scale=v_scale,
                              num_splits=num_splits)


def paged_prefill_attention(q: torch.Tensor, kp: torch.Tensor,
                            vp: torch.Tensor, tbl: torch.Tensor,
                            pos: torch.Tensor, start: torch.Tensor,
                            scale: float, *,
                            k_scale: torch.Tensor | None = None,
                            v_scale: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """One paged GQA prefill chunk: q [B, S, H, hd] scored in place
    against the block pool; column ``i`` of row ``b`` attends
    ``start[b] <= j <= pos[b] + i``. The chunk's K/V are already in the
    pool."""
    return paged_flash_prefill(q.contiguous(), kp, vp, tbl, pos, start,
                               scale=scale, k_scale=k_scale,
                               v_scale=v_scale)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor,
        h0: torch.Tensor | None = None):
    """Mamba-2 SSD over x [B, S, H, P] with dt [B, S, H], a [H] and gates
    b / c [B, S, G, N], from the state h0 [B·H, N, P] (None: zero).

    Head ``h`` reads group ``h // (H / G)``: the kernel indexes the group
    and reads every input through its strides, so neither the repeat of
    the gates to heads nor the ``(B, H)`` flattening copies is made on the
    card (the plain version makes both, as the JAX package does). Returns
    (y [B, S, H, P] fp32, final state [B·H, N, P] fp32).
    """
    heads, g = x.shape[2], b.shape[2]
    if heads % g:
        raise ValueError(f"{heads} SSD heads are not a multiple of {g} "
                         "groups")
    h0 = None if h0 is None else h0.float().contiguous()
    return ssd_scan(x.float(), dt.float(), a.float().contiguous(), b.float(),
                    c.float(), h0)
