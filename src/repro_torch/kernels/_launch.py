"""What the kernel wrappers share: argument checks, and the launch plan
that each CUDA library computes for a shape.

The tiling lives in the ``.cu`` sources alone. Each library exports
``<name>_plan``, which picks the mapping from M (the GEMV-shaped decode
kernel for M ≤ 8, the tiled kernel otherwise) and splits K over blocks for
this card; the wrapper allocates the split-K scratch the plan needs and
launches ``<name>_f32`` with the plan's split.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

MAPPINGS = ("gemv", "tiled")


class Plan(NamedTuple):
    """How a kernel runs one [M, K] @ [K, N] call on the card."""

    mapping: str        # "gemv" (decode, M ≤ 8) or "tiled"
    splits: int         # ranges the K loop is split into, one block each
    k_per_split: int    # rows of K per split


@functools.lru_cache(maxsize=None)
def plan(kernel: str, m: int, k: int, n: int, device_index: int) -> Plan:
    """``kernel``'s plan for an [M, K] @ [K, N] call on CUDA device
    ``device_index`` (builds and loads the library at first use)."""
    fn = getattr(_build.load(kernel), f"{kernel}_plan")
    out = [ctypes.c_int() for _ in range(3)]
    err = fn(ctypes.c_int(m), ctypes.c_int(k), ctypes.c_int(n),
             ctypes.c_int(sm_count(device_index)),
             *(ctypes.byref(o) for o in out))
    if err:
        raise ValueError(f"{kernel} cannot take the shape M={m}, K={k}, "
                         f"N={n} (CUDA error {err})")
    mapping, splits, rows = (o.value for o in out)
    return Plan(MAPPINGS[mapping], splits, rows)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def scratch(p: Plan, m: int, n: int, device) -> torch.Tensor | None:
    """The fp32 split-K scratch ``[splits, M, N]`` of a plan, or None."""
    if p.splits == 1:
        return None
    return torch.empty((p.splits, m, n), dtype=torch.float32, device=device)


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
