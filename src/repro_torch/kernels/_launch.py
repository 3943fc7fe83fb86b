"""What the kernel wrappers share: argument checks, and the launch plan
that each CUDA library computes for a shape.

The tiling lives in the ``.cu`` sources alone. Each library exports
``<name>_plan``, which picks the mapping from M (and, for ``analog_matmul``,
the DAC width): the GEMV-shaped decode kernel for M ≤ 8, the tensor-core
kernel otherwise, or the CUDA-core tiled kernel where the DAC lattice is
not exact in TF32; it splits K over blocks for this card and says how much
fp32 scratch the launch needs. The wrapper allocates that scratch and
launches ``<name>_f32`` with the plan's split.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

MAPPINGS = ("gemv", "mma", "tiled")


class Plan(NamedTuple):
    """How a kernel runs one [M, K] @ [K, N] call on the card."""

    mapping: str        # "gemv" (decode, M ≤ 8), "mma" or "tiled"
    splits: int         # ranges the K loop is split into, one block each
    k_per_split: int    # rows of K per split
    scratch: int        # fp32 scratch elements of a launch (0: none)


@functools.lru_cache(maxsize=None)
def plan(kernel: str, m: int, k: int, n: int, device_index: int,
         in_bits: int | None = None) -> Plan:
    """``kernel``'s plan for an [M, K] @ [K, N] call on CUDA device
    ``device_index`` (builds and loads the library at first use);
    ``in_bits`` is ``analog_matmul``'s DAC width and None for
    ``int4_matmul``."""
    fn = getattr(_build.load(kernel), f"{kernel}_plan")
    shape = (m, k, n) if in_bits is None else (m, k, n, in_bits)
    out = [ctypes.c_int() for _ in range(3)]
    scratch = ctypes.c_longlong()
    err = fn(*(ctypes.c_int(v) for v in shape),
             ctypes.c_int(sm_count(device_index)),
             *(ctypes.byref(o) for o in out), ctypes.byref(scratch))
    if err:
        raise ValueError(f"{kernel} cannot take the shape M={m}, K={k}, "
                         f"N={n} (CUDA error {err})")
    mapping, splits, rows = (o.value for o in out)
    return Plan(MAPPINGS[mapping], splits, rows, scratch.value)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def scratch(p: Plan, device) -> torch.Tensor | None:
    """The fp32 scratch of a plan's launch, or None when it needs none."""
    if p.scratch == 0:
        return None
    return torch.empty((p.scratch,), dtype=torch.float32, device=device)


def check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class ScanPlan(NamedTuple):
    """How the ``ssd_scan`` kernel runs one scan on the card."""

    chunk: int          # tokens per chunk (L)
    launches: int       # device launches of a scan: 1 (one chunk) or 3
    blocks: tuple       # thread blocks of each launch, in launch order
    smem: int           # largest dynamic shared memory of a block, bytes
    scratch: int        # bytes of device scratch a scan needs (0: none)


@functools.lru_cache(maxsize=None)
def ssd_plan(b: int, s: int, h: int, p: int, n: int, g: int,
             passes: bool = False) -> ScanPlan:
    """The ``ssd_scan`` library's plan for x [B, S, H, P] with b / c
    [B, S, G, N] (builds and loads the library at first use); ``passes``
    plans the chunk, state and output passes even for a single chunk.
    Raises ``ValueError`` for a shape the kernel does not take."""
    fn = _build.load("ssd_scan").ssd_scan_plan
    chunk, launches, smem = (ctypes.c_int() for _ in range(3))
    blocks = (ctypes.c_int * 3)()
    scratch = ctypes.c_longlong()
    err = fn(*(ctypes.c_int(v) for v in (b, s, h, p, n, g, int(passes))),
             ctypes.byref(chunk), ctypes.byref(launches), blocks,
             ctypes.byref(smem), ctypes.byref(scratch))
    if err:
        raise ValueError(f"ssd_scan cannot take B={b}, S={s}, H={h}, P={p}, "
                         f"N={n}, G={g} (CUDA error {err})")
    return ScanPlan(chunk.value, launches.value,
                    tuple(blocks[:launches.value]), smem.value,
                    scratch.value)
