"""Chunked Mamba-2 SSD scan with the incoming and the final state.

The hand-written CUDA kernel ``csrc/ssd_scan.cu`` replaces the Pallas TPU
kernel of the JAX package (``kernels/ssd_scan.py::ssd_scan``) and folds in
what ``models/mamba2.py::_ssd_with_state`` adds around it there: the
incoming state's terms and the final state. It reads x, dt, b and c in the
mixer's layout through their strides, and b / c per group (no repeat to
heads). A scan of up to 32 tokens (one chunk) is one device launch; a
longer one is three at chunks of 64 (chunk summaries, the state pass over
chunks, the outputs), which share a scratch buffer that the wrapper
allocates on the current stream.

The wrapper runs the kernel for a CUDA tensor and the plain version
(:func:`repro_torch.kernels.ref.ssd_scan_ref`) for a CPU tensor; there is no
fallback from one to the other. ``launches`` counts scans run on the kernel
(one per call, whatever the plan's device launches).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch, ref

#: scans run on the kernel since the last reset (the plain CPU version adds
#: nothing)
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.cache
def _lib():
    """The built library's entry point with its C signature declared
    (built and loaded at the first launch)."""
    fn = _build.load("ssd_scan").ssd_scan
    fn.argtypes = ([_P] + [_L] * 3 + [_P] + [_L] * 3 + [_P] * 2 + [_L] * 3
                   + [_P] + [_L] * 3 + [_P] * 3 + [_I] * 8 + [_P] * 2)
    fn.restype = _I
    return fn


def _check_strided(name: str, t: torch.Tensor, shape, dev) -> None:
    """Raise unless ``t`` is an fp32 tensor of ``shape`` on ``dev`` whose
    last dimension is contiguous (the kernel takes the other strides)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dimension")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor | None = None, *, passes: bool = False):
    """Mamba-2 SSD over a whole sequence, from ``h0``.

    x [B, S, H, P], dt [B, S, H], a [H] (negative), b / c [B, S, G, N]
    (head ``h`` reads group ``h // (H / G)``), h0 [B·H, N, P] or None (a
    zero state). On the card every tensor must be fp32 with its last
    dimension contiguous (x, dt, b and c may be strided views); the
    library's plan (``_launch.ssd_plan``) refuses shapes it does not take.
    ``passes`` runs the chunk, state and output passes even where the plan
    takes one launch (``chip_smoke.py`` times the two against each other).
    Returns (y [B, S, H, P] fp32, final state [B·H, N, P] fp32).
    """
    global launches
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, a, b, c, h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError("ssd_scan takes x [B, S, H, P] and b / c "
                         "[B, S, G, N]")
    bsz, s, heads, pdim = x.shape
    g, n = b.shape[2], b.shape[3]
    dev = x.device
    _check_strided("x", x, (bsz, s, heads, pdim), dev)
    _check_strided("dt", dt, (bsz, s, heads), dev)
    _check_strided("b", b, (bsz, s, g, n), dev)
    _check_strided("c", c, (bsz, s, g, n), dev)
    _launch.check("a", a, torch.float32, (heads,), dev)
    if h0 is not None:
        _launch.check("h0", h0, torch.float32, (bsz * heads, n, pdim), dev)
    plan = _launch.ssd_plan(bsz, s, heads, pdim, n, g, passes)
    y = torch.empty((bsz, s, heads, pdim), dtype=torch.float32, device=dev)
    h = torch.empty((bsz * heads, n, pdim), dtype=torch.float32, device=dev)
    scratch = (torch.empty((plan.scratch // 4,), dtype=torch.float32,
                           device=dev) if plan.scratch else None)
    err = _lib()(x.data_ptr(), *x.stride()[:3], dt.data_ptr(),
                 *dt.stride()[:3], a.data_ptr(), b.data_ptr(),
                 *b.stride()[:3], c.data_ptr(), *c.stride()[:3],
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 h.data_ptr(), bsz, s, heads, pdim, n, g, plan.chunk,
                 int(passes), None if scratch is None else scratch.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    launches += 1
    return y, h
