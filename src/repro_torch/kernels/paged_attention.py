"""Paged flash-decode attention: one GQA decode step per row against the
block-paged KV pool.

The hand-written CUDA kernel ``csrc/paged_attention.cu`` replaces the
Pallas TPU kernel of the JAX package
(``kernels/paged_attention.py::paged_flash_decode``). Each row reads only
its live blocks ``start // bs … pos // bs`` through the block table; with
``num_splits > 1`` the block loop is split over thread blocks and a second
kernel of the same library merges the partials in split order. Inside a
thread block the live blocks are split again over warps, which merge in
warp order (:func:`decode_plan` reports the mapping).

The wrapper runs the kernel for a CUDA tensor and the plain version
(:func:`repro_torch.kernels.ref.paged_decode_ref`) for a CPU tensor; there
is no fallback from one to the other. A meta tensor is checked as on the
card and gets an empty result. Every call reports its work, by shape, to
the active cost counters (``kernels.cost``). ``launches`` counts the
calls that launched the kernel (its merge pass included).
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
    fn = _build.load("paged_attention").paged_decode
    fn.argtypes = [_P] * 12 + [_I] * 8 + [ctypes.c_float, _I, _P]
    fn.restype = _I
    return fn


@functools.lru_cache(maxsize=None)
def decode_plan(nq: int, nkv: int, hd: int, bs: int,
                dtype: torch.dtype) -> _paged.Plan:
    """The library's plan for a decode step of ``nq`` query heads on
    ``nkv`` kv heads of width ``hd`` over a pool of ``bs``-token blocks of
    ``dtype`` (builds and loads the library at first use)."""
    fn = _build.load("paged_attention").paged_decode_plan
    return _paged.plan(fn, nq, nkv, hd, bs, _paged.KV_DTYPES[dtype])


def paged_flash_decode(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                       tbl: torch.Tensor, pos: torch.Tensor,
                       start: torch.Tensor, *, scale: float,
                       k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None,
                       num_splits: int = 1) -> torch.Tensor:
    """Paged flash-decode attention.

    q [B, H, hd]; kp / vp [P, bs, KV, hd] (fp32, bf16, or int8 with
    k_scale / v_scale [P, bs, KV] fp32); tbl [B, NB], pos / start [B]
    int32. Row ``b`` attends ``start[b] <= j <= pos[b]``. On the card q
    must be fp32 and every tensor contiguous. Returns [B, H, hd] in
    ``q.dtype``.
    """
    return cost.counted(
        "paged_flash_decode", lambda: cost.paged_work(q, kp, tbl),
        lambda: _decode(q, kp, vp, tbl, pos, start, scale, k_scale,
                        v_scale, num_splits),
        lambda: cost.paged_attended(q, kp, tbl, pos, start))


def _decode(q, kp, vp, tbl, pos, start, scale, k_scale, v_scale,
            num_splits):
    """The call on the plain version (CPU), the card, or the meta
    device."""
    global launches
    if q.device.type == "cpu":
        return ref.paged_decode_ref(q, kp, vp, tbl, pos, start, scale,
                                    k_scale, v_scale, num_splits)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"paged_flash_decode runs on cuda, cpu or meta, "
                         f"not {q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be [B, H, hd], got {tuple(q.shape)}")
    bsz, nq, hd = q.shape
    dev = q.device
    _launch.check("q", q, torch.float32, (bsz, nq, hd), dev)
    npool, bs, nkv, nb, code = _paged.check_pool(
        kp, vp, k_scale, v_scale, tbl, pos, start, bsz, nq, hd, dev)
    if num_splits < 1:
        raise ValueError(f"num_splits must be >= 1, got {num_splits}")
    out = torch.empty((bsz, nq, hd), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return out
    o_part = m_part = l_part = None
    if num_splits > 1:
        o_part = torch.empty((bsz, num_splits, nq, hd), dtype=torch.float32,
                             device=dev)
        m_part = torch.empty((bsz, num_splits, nq), dtype=torch.float32,
                             device=dev)
        l_part = torch.empty_like(m_part)
    p = _paged.ptr
    err = _lib()(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), p(k_scale),
                 p(v_scale), tbl.data_ptr(), pos.data_ptr(),
                 start.data_ptr(), out.data_ptr(), p(o_part), p(m_part),
                 p(l_part), bsz, nq, nkv, hd, bs, nb, npool, num_splits,
                 scale, code, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged_flash_decode launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
