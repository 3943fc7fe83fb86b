"""Fused analog MVM: DAC-quant → fp32 MVM → per-column ADC-quant.

One AIMC tile execution (paper eqs. 1 and 2) as one hand-written CUDA
kernel for Hopper, ``csrc/analog_matmul.cu``. It replaces the Pallas TPU
kernel of the JAX package (``kernels/analog_matmul.py::analog_matmul``).
The ADC bound is either given, or folded into the kernel's own pass over
the weights (``lam``): ``(lam · β) · max_k |w_eff[k, n]|``, bit for bit
what :func:`repro_torch.kernels.ref.adc_bound` computes.

A MoE site's experts run in one launch: x [E, M, K] against w_eff
[E, K, N], each expert on its own slices (the reference's vmap over
experts, which Pallas' batching rule turns into a grid dimension).

The wrapper runs the kernel for a CUDA tensor and the plain version
(:func:`repro_torch.kernels.ref.analog_matmul_ref`) for a CPU tensor; there
is no fallback from one to the other. A meta tensor is checked as on the
card and gets an empty result (the dry run's shape-only call). Every call
reports its work to the active cost counters (``kernels.cost``).
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch, cost, ref

#: kernel launches since the last reset (the plain CPU version adds nothing)
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    """The built library's entry point with its C signature declared
    (built and loaded at the first launch)."""
    fn = _build.load("analog_matmul").analog_matmul_f32
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   ctypes.c_float, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def analog_matmul(x: torch.Tensor, w_eff: torch.Tensor, beta: torch.Tensor,
                  bound: torch.Tensor | None = None,
                  col_off: torch.Tensor | None = None, *,
                  lam: float | None = None, in_bits: int = 8,
                  out_bits: int = 8, promote: bool = True,
                  plan_shape: tuple[int, int] | None = None,
                  plan_rows: int | None = None) -> torch.Tensor:
    """Fused DAC-quant → MVM → ADC-quant of ``x [M, K] @ w_eff [K, N]``,
    or of E experts at once: ``x [E, M, K] @ w_eff [E, K, N]``.

    beta: one-element static input range (shared by the experts); bound
    [N] ([E, N]): per-column ADC bound, or None with ``lam`` to fold ``lam ·
    β · max|w_eff[.., :, n]|`` into the kernel (exactly one of the two);
    col_off [N] ([E, N]) or None: per-column offset added before the ADC.
    On the card every tensor must be fp32 and contiguous; the library picks
    its mapping and split-K from the shape and ``in_bits``
    (``_launch.plan``). ``promote=False`` only measures what promotion
    buys: the tensor cores of the ``mma`` mapping then carry the whole K
    sum. ``plan_shape`` ``(E, N)`` plans the launch as one of E experts
    and N columns (a tensor-parallel shard of a larger site runs the whole
    site's mapping and K split; its scratch covers the shard).
    ``plan_rows`` plans it as a launch of that many rows (a data shard of
    a training batch runs the whole batch's K split, where both take the
    same mapping, so that each row sums K as in the whole launch). Returns
    fp32.
    """
    ref.check_one_bound(bound, lam)

    def work():
        e = x.shape[0] if x.dim() == 3 else 1
        return cost.analog_matmul(e, x.shape[-2], x.shape[-1],
                                  w_eff.shape[-1], bound=bound is not None,
                                  col_off=col_off is not None)

    return cost.counted("analog_matmul", work, lambda: _analog_matmul(
        x, w_eff, beta, bound, col_off, lam, in_bits, out_bits, promote,
        plan_shape, plan_rows))


def _analog_matmul(x, w_eff, beta, bound, col_off, lam, in_bits, out_bits,
                   promote, plan_shape, plan_rows):
    """The call on the plain version (CPU), the card, or the meta
    device."""
    global launches
    if x.device.type == "cpu":
        return ref.analog_matmul_ref(x, w_eff, beta, bound, col_off, lam=lam,
                                     in_bits=in_bits, out_bits=out_bits)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"analog_matmul runs on cuda, cpu or meta, not "
                         f"{x.device}")
    if x.dim() not in (2, 3) or w_eff.dim() != x.dim():
        raise ValueError("analog_matmul takes x [M, K] and w_eff [K, N], "
                         "or x [E, M, K] and w_eff [E, K, N]")
    lead = tuple(x.shape[:-2])            # () or (E,)
    e = x.shape[0] if lead else 1
    m, k = x.shape[-2:]
    n = w_eff.shape[-1]
    dev = x.device
    _launch.check("x", x, torch.float32, lead + (m, k), dev)
    _launch.check("w_eff", w_eff, torch.float32, lead + (k, n), dev)
    _launch.check("beta", beta.reshape(1), torch.float32, (1,), dev)
    if bound is not None:
        _launch.check("bound", bound, torch.float32, lead + (n,), dev)
    if col_off is not None:
        _launch.check("col_off", col_off, torch.float32, lead + (n,), dev)
    if not (2 <= in_bits <= 24 and 2 <= out_bits <= 24):
        raise ValueError(f"bits out of range: {in_bits}, {out_bits}")
    if dev.type == "meta":
        return torch.empty(lead + (m, n), dtype=torch.float32, device=dev)
    pe, pn = (e, n) if plan_shape is None else plan_shape
    plan = _launch.plan("analog_matmul", m, k, pn, dev.index, in_bits, pe)
    if plan_rows is not None and plan_rows != m:
        whole = _launch.plan("analog_matmul", plan_rows, k, pn, dev.index,
                             in_bits, pe)
        if whole.mapping == plan.mapping:   # its scratch covers fewer rows
            plan = whole
    out = torch.empty(lead + (m, n), dtype=torch.float32, device=dev)
    scratch = _launch.scratch(plan, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(x.data_ptr(), w_eff.data_ptr(), beta.data_ptr(),
                 None if bound is None else bound.data_ptr(),
                 None if col_off is None else col_off.data_ptr(),
                 out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 e, m, k, n, in_bits, out_bits,
                 0.0 if lam is None else float(lam), plan.splits,
                 plan.k_per_split, int(promote), stream)
    if err:
        raise RuntimeError(f"analog_matmul launch failed: CUDA error {err}")
    launches += 1
    return out
