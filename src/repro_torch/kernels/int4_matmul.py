"""Packed-int4 weight × fp32 activation matmul (digital deployment path).

Table 3 of the paper deploys the analog foundation models on 4-bit digital
hardware through per-channel RTN. The hand-written CUDA kernel
``csrc/int4_matmul.cu`` keeps the weights packed two per byte in device
memory and unpacks them on chip: ``y = (x @ (nibble - 8)) * scale``. It
replaces the Pallas TPU kernel ``kernels/int4_matmul.py::int4_matmul`` of
the JAX package.

A MoE site's experts run in one launch: x [E, M, K] against w_packed
[E, K, N//2] with scale [E, N].

The wrapper runs the kernel for a CUDA tensor and the plain version
(:func:`repro_torch.kernels.ref.int4_matmul_ref`) for a CPU tensor; there
is no fallback from one to the other. A meta tensor is checked as on the
card and gets an empty result. Every call reports its work to the active
cost counters (``kernels.cost``). ``launches`` counts kernel launches.
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
    fn = _build.load("int4_matmul").int4_matmul_f32
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                scale: torch.Tensor,
                plan_shape: tuple[int, int] | None = None) -> torch.Tensor:
    """``y = x @ dequant(w_packed, scale)``: x [M, K] fp32, w_packed
    [K, N//2] uint8, scale [N] fp32 → [M, N] fp32; or E experts at once
    with a leading E on each (scale [E, N]). On the card the library picks
    its mapping and split-K from the shape (``_launch.plan``);
    ``plan_shape`` ``(E, N)`` plans it as one of E experts and N columns
    (a tensor-parallel shard runs its whole site's plan)."""
    def work():
        e = x.shape[0] if x.dim() == 3 else 1
        return cost.int4_matmul(e, x.shape[-2], x.shape[-1],
                                2 * w_packed.shape[-1])

    return cost.counted("int4_matmul", work, lambda: _int4_matmul(
        x, w_packed, scale, plan_shape))


def _int4_matmul(x, w_packed, scale, plan_shape):
    """The call on the plain version (CPU), the card, or the meta
    device."""
    global launches
    if x.device.type == "cpu":
        return ref.int4_matmul_ref(x, w_packed, scale)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"int4_matmul runs on cuda, cpu or meta, not "
                         f"{x.device}")
    if x.dim() not in (2, 3) or w_packed.dim() != x.dim():
        raise ValueError("int4_matmul takes x [M, K] and w_packed [K, N//2],"
                         " or x [E, M, K] and w_packed [E, K, N//2]")
    lead = tuple(x.shape[:-2])            # () or (E,)
    e = x.shape[0] if lead else 1
    m, k = x.shape[-2:]
    n = 2 * w_packed.shape[-1]
    dev = x.device
    _launch.check("x", x, torch.float32, lead + (m, k), dev)
    _launch.check("w_packed", w_packed, torch.uint8, lead + (k, n // 2), dev)
    _launch.check("scale", scale, torch.float32, lead + (n,), dev)
    if dev.type == "meta":
        return torch.empty(lead + (m, n), dtype=torch.float32, device=dev)
    pe, pn = (e, n) if plan_shape is None else plan_shape
    plan = _launch.plan("int4_matmul", m, k, pn, dev.index, None, pe)
    out = torch.empty(lead + (m, n), dtype=torch.float32, device=dev)
    scratch = _launch.scratch(plan, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
                 out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(),
                 e, m, k, n, plan.splits, plan.k_per_split, stream)
    if err:
        raise RuntimeError(f"int4_matmul launch failed: CUDA error {err}")
    launches += 1
    return out
