"""Fused analog MVM: DAC-quant → fp32 MVM → per-column ADC-quant.

One AIMC tile execution (paper eqs. 1 and 2) as one hand-written CUDA
kernel for Hopper, ``csrc/analog_matmul.cu``. It replaces the Pallas TPU
kernel of the JAX package (``kernels/analog_matmul.py::analog_matmul``).
The ADC bound is either given, or folded into the kernel's own pass over
the weights (``lam``): ``(lam · β) · max_k |w_eff[k, n]|``, bit for bit
what :func:`repro_torch.kernels.ref.adc_bound` computes.

The wrapper runs the kernel for a CUDA tensor and the plain version
(:func:`repro_torch.kernels.ref.analog_matmul_ref`) for a CPU tensor; there
is no fallback from one to the other. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch, ref

#: kernel launches since the last reset (the plain CPU version adds nothing)
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    """The built library's entry point with its C signature declared
    (built and loaded at the first launch)."""
    fn = _build.load("analog_matmul").analog_matmul_f32
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   ctypes.c_float, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def analog_matmul(x: torch.Tensor, w_eff: torch.Tensor, beta: torch.Tensor,
                  bound: torch.Tensor | None = None,
                  col_off: torch.Tensor | None = None, *,
                  lam: float | None = None, in_bits: int = 8,
                  out_bits: int = 8, promote: bool = True) -> torch.Tensor:
    """Fused DAC-quant → MVM → ADC-quant of ``x [M, K] @ w_eff [K, N]``.

    beta: one-element static input range; bound [N]: per-column ADC bound,
    or None with ``lam`` to fold ``lam · β · max|w_eff[:, n]|`` into the
    kernel (exactly one of the two); col_off [N] or None: per-column offset
    added before the ADC. On the card every tensor must be fp32 and
    contiguous; the library picks its mapping and split-K from the shape
    and ``in_bits`` (``_launch.plan``). ``promote=False`` only measures
    what promotion buys: the tensor cores of the ``mma`` mapping then carry
    the whole K sum. Returns fp32.
    """
    global launches
    ref.check_one_bound(bound, lam)
    if x.device.type == "cpu":
        return ref.analog_matmul_ref(x, w_eff, beta, bound, col_off, lam=lam,
                                     in_bits=in_bits, out_bits=out_bits)
    if x.device.type != "cuda":
        raise ValueError(f"analog_matmul runs on cuda or cpu, not {x.device}")
    if x.dim() != 2 or w_eff.dim() != 2:
        raise ValueError("analog_matmul takes x [M, K] and w_eff [K, N]")
    m, k = x.shape
    n = w_eff.shape[1]
    dev = x.device
    _launch.check("x", x, torch.float32, (m, k), dev)
    _launch.check("w_eff", w_eff, torch.float32, (k, n), dev)
    _launch.check("beta", beta.reshape(1), torch.float32, (1,), dev)
    if bound is not None:
        _launch.check("bound", bound, torch.float32, (n,), dev)
    if col_off is not None:
        _launch.check("col_off", col_off, torch.float32, (n,), dev)
    if not (2 <= in_bits <= 24 and 2 <= out_bits <= 24):
        raise ValueError(f"bits out of range: {in_bits}, {out_bits}")
    plan = _launch.plan("analog_matmul", m, k, n, dev.index, in_bits)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    scratch = _launch.scratch(plan, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(x.data_ptr(), w_eff.data_ptr(), beta.data_ptr(),
                 None if bound is None else bound.data_ptr(),
                 None if col_off is None else col_off.data_ptr(),
                 out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 m, k, n, in_bits, out_bits,
                 0.0 if lam is None else float(lam), plan.splits,
                 plan.k_per_split, int(promote), stream)
    if err:
        raise RuntimeError(f"analog_matmul launch failed: CUDA error {err}")
    launches += 1
    return out
