"""Packed-int4 weight × fp32 activation matmul (digital deployment path).

Table 3 of the paper deploys the analog foundation models on 4-bit digital
hardware through per-channel RTN. The hand-written CUDA kernel
``csrc/int4_matmul.cu`` keeps the weights packed two per byte in device
memory and unpacks them on chip: ``y = (x @ (nibble - 8)) * scale``. It
replaces the Pallas TPU kernel ``kernels/int4_matmul.py::int4_matmul`` of
the JAX package.

The wrapper runs the kernel for a CUDA tensor and the plain version
(:func:`repro_torch.kernels.ref.int4_matmul_ref`) for a CPU tensor; there
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
    fn = _build.load("int4_matmul").int4_matmul_f32
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``y = x @ dequant(w_packed, scale)``: x [M, K] fp32, w_packed
    [K, N//2] uint8, scale [N] fp32 → [M, N] fp32. On the card the library
    picks its mapping and split-K from the shape (``_launch.plan``)."""
    global launches
    if x.device.type == "cpu":
        return ref.int4_matmul_ref(x, w_packed, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul runs on cuda or cpu, not {x.device}")
    if x.dim() != 2 or w_packed.dim() != 2:
        raise ValueError("int4_matmul takes x [M, K] and w_packed [K, N//2]")
    m, k = x.shape
    n = 2 * w_packed.shape[1]
    dev = x.device
    _launch.check("x", x, torch.float32, (m, k), dev)
    _launch.check("w_packed", w_packed, torch.uint8, (k, n // 2), dev)
    _launch.check("scale", scale, torch.float32, (n,), dev)
    plan = _launch.plan("int4_matmul", m, k, n, dev.index)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    scratch = _launch.scratch(plan, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
                 out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 m, k, n, plan.splits, plan.k_per_split, stream)
    if err:
        raise RuntimeError(f"int4_matmul launch failed: CUDA error {err}")
    launches += 1
    return out
