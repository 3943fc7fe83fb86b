"""What the two paged-attention wrappers share: the pool's element type
codes, the checks of the pool, the tables and the cursors, and the launch
plan each library reports for a shape."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _launch

#: pool element type → the ``kv_dtype`` code of the C entry points
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def check_pool(kp, vp, k_scale, v_scale, tbl, pos, start, bsz: int,
               nq: int, hd: int, dev) -> tuple[int, int, int, int, int]:
    """Raise unless the pool, scales, tables and cursors are what the
    kernels take. Returns ``(P, bs, KV, NB, kv_dtype code)``."""
    if kp.dim() != 4:
        raise ValueError(f"kp must be [P, bs, KV, hd], got {tuple(kp.shape)}")
    npool, bs, nkv, _ = kp.shape
    if kp.dtype not in KV_DTYPES:
        raise TypeError(f"pool dtype {kp.dtype} is not one of "
                        f"{list(KV_DTYPES)}")
    if nq % nkv:
        raise ValueError(f"{nq} query heads are not a multiple of {nkv} "
                         "kv heads")
    _launch.check("kp", kp, kp.dtype, (npool, bs, nkv, hd), dev)
    _launch.check("vp", vp, kp.dtype, (npool, bs, nkv, hd), dev)
    quantized = kp.dtype == torch.int8
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("scales go with an int8 pool, and only with one")
    if quantized:
        _launch.check("k_scale", k_scale, torch.float32, (npool, bs, nkv),
                      dev)
        _launch.check("v_scale", v_scale, torch.float32, (npool, bs, nkv),
                      dev)
    if tbl.dim() != 2:
        raise ValueError(f"tbl must be [B, NB], got {tuple(tbl.shape)}")
    nb = tbl.shape[1]
    _launch.check("tbl", tbl, torch.int32, (bsz, nb), dev)
    _launch.check("pos", pos, torch.int32, (bsz,), dev)
    _launch.check("start", start, torch.int32, (bsz,), dev)
    return npool, bs, nkv, nb, KV_DTYPES[kp.dtype]


def ptr(t: torch.Tensor | None):
    """A tensor's device pointer, or None."""
    return None if t is None else t.data_ptr()


class Plan(NamedTuple):
    """How a paged kernel runs a shape on the card: each warp of a thread
    block walks its share of the live pool blocks, one block of ``bs``
    keys per iteration, split over its lanes."""

    warps: int         # warps of a thread block
    tile: int          # query vectors of a thread block
    key_lanes: int     # lanes of a warp splitting a pool block's keys
    chunk_lanes: int   # lanes of a warp splitting a row, 8 elements each
    stages: int        # pool blocks in flight per warp (cp.async ring)


def plan(fn, *shape: int) -> Plan:
    """The plan that the library function ``fn`` (``paged_decode_plan`` or
    ``paged_prefill_plan``) gives for ``shape``; raises ``ValueError`` for
    a shape its kernel does not take."""
    out = [ctypes.c_int() for _ in range(5)]
    err = fn(*(ctypes.c_int(v) for v in shape),
             *(ctypes.byref(o) for o in out))
    if err:
        raise ValueError(f"the paged kernel cannot take {shape} (CUDA error "
                         f"{err})")
    return Plan(*(o.value for o in out))
