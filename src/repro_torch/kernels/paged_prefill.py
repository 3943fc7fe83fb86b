"""Paged flash-prefill attention: one query chunk per row scored in place
against the block-paged KV pool.

The hand-written CUDA kernel ``csrc/paged_prefill.cu`` replaces the Pallas
TPU kernel of the JAX package
(``kernels/paged_prefill.py::paged_flash_prefill``). Column ``i`` of row
``b`` sits at logical position ``pos[b] + i`` and attends
``start[b] <= j <= pos[b] + i``; only the row's live blocks are read. The
kernel reads the pool through the read table ``tbl`` and never writes it:
the chunk's K/V were scattered by the caller, through the write table. A
thread block holds a tile of query vectors and splits the row's live
blocks over its warps (:func:`prefill_plan` reports the mapping).

The wrapper runs the kernel for a CUDA tensor and the plain version
(:func:`repro_torch.kernels.ref.paged_prefill_ref`) for a CPU tensor;
there is no fallback from one to the other. A meta tensor is checked as
on the card and gets an empty result. Every call reports its work, by
shape, to the active cost counters (``kernels.cost``). ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _launch, _paged, cost, ref

#: kernel launches since the last reset (the plain CPU version adds nothing)
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib():
    """The built library's entry point with its C signature declared
    (built and loaded at the first launch)."""
    fn = _build.load("paged_prefill").paged_prefill
    fn.argtypes = [_P] * 9 + [_I] * 8 + [ctypes.c_float, _I, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def prefill_plan(hd: int, bs: int, dtype: torch.dtype) -> _paged.Plan:
    """The library's plan for a prefill chunk of rows of width ``hd`` over
    a pool of ``bs``-token blocks of ``dtype`` (builds and loads the
    library at first use)."""
    fn = _build.load("paged_prefill").paged_prefill_plan
    return _paged.plan(fn, hd, bs, _paged.KV_DTYPES[dtype])


def paged_flash_prefill(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                        tbl: torch.Tensor, pos: torch.Tensor,
                        start: torch.Tensor, *, scale: float,
                        k_scale: torch.Tensor | None = None,
                        v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Paged flash-prefill attention.

    q [B, S, H, hd]; the pool, scales, tables and cursors as in
    :func:`repro_torch.kernels.paged_attention.paged_flash_decode`, with
    ``pos[b]`` the logical position of row ``b``'s first column. On the
    card q must be fp32 and every tensor contiguous. Returns
    [B, S, H, hd] in ``q.dtype``.
    """
    return cost.counted(
        "paged_flash_prefill", lambda: cost.paged_work(q, kp, tbl),
        lambda: _prefill(q, kp, vp, tbl, pos, start, scale, k_scale,
                         v_scale),
        lambda: cost.paged_attended(q, kp, tbl, pos, start))


def _prefill(q, kp, vp, tbl, pos, start, scale, k_scale, v_scale):
    """The call on the plain version (CPU), the card, or the meta
    device."""
    global launches
    if q.device.type == "cpu":
        return ref.paged_prefill_ref(q, kp, vp, tbl, pos, start, scale,
                                     k_scale, v_scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"paged_flash_prefill runs on cuda, cpu or meta, "
                         f"not {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, hd], got {tuple(q.shape)}")
    bsz, s, nq, hd = q.shape
    dev = q.device
    _launch.check("q", q, torch.float32, (bsz, s, nq, hd), dev)
    npool, bs, nkv, nb, code = _paged.check_pool(
        kp, vp, k_scale, v_scale, tbl, pos, start, bsz, nq, hd, dev)
    out = torch.empty((bsz, s, nq, hd), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return out
    p = _paged.ptr
    err = _lib()(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), p(k_scale),
                 p(v_scale), tbl.data_ptr(), pos.data_ptr(),
                 start.data_ptr(), out.data_ptr(), bsz, s, nq, nkv, hd, bs,
                 nb, npool, scale, code,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged_flash_prefill launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
