"""The port's own count of the work of a step: FLOPs, bytes, kernel calls,
gathers and the peak of live tensor bytes.

The counterpart of the JAX package's ``launch/hlo_analysis.py``, which
parses XLA's optimized HLO and counts each ``dot`` as ``2 · result
elements · contracted size`` (its ``_dot_flops``), the collectives' output
bytes, and the operand and result bytes of every top-level instruction.
The port has no HLO: :class:`CostCounter` is a ``TorchDispatchMode`` that
sees every aten op that runs inside it (a forward, a train step with its
backward and the recompute of its checkpoints, an engine step), on meta,
CPU or CUDA tensors alike.

* ``flops``: the matmul-class ops (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``addbmm``, ``mv``, ``addmv``, ``dot``, ``vdot``; ``matmul``,
  ``linear`` and ``einsum`` reach the counter as these) by the reference's
  dot rule, the SDPA family if it appears (``4 · B · H · Sq · Sk · d`` a
  forward, twice that a backward), plus each kernel call's FLOPs.
* ``hbm_bytes``: the operand and result bytes of every op but views,
  ``empty`` and copies from one device to another (a host scalar sent to
  the card, which the CPU's ``.to`` does not run at all), plus each
  kernel call's bytes (``kernels.cost``). This is the
  port's own memory model: eager torch does not fuse, so every op reads
  its inputs and writes its outputs. It is not XLA's fused count.
* ``collective_bytes`` / ``collective_counts`` / ``collective_total_bytes``:
  what the tensor-parallel engine's gathers (``distributed.sharding``)
  and the sharded train step's gathers and reduce-scatters
  (``distributed.placement``) report, keyed by the reference's collective
  names.
* ``kernels``: ``{name: {"calls", "flops", "bytes"}}`` of the five kernel
  wrappers. A wrapper reports one call by its shapes and hides the ops it
  runs (the plain version on the CPU), so a call counts the same on every
  device. The paged kernels' ``flops`` and ``bytes`` are the table's
  capacity (the JAX package's and XLA's count); their entries also hold
  ``attended_flops`` / ``attended_bytes``, the keys the cursors reach,
  which is the kernels' work, or None where a call's cursors could not be
  read (on the card and on the meta device: ``kernels.cost``).
* ``attended_flops`` / ``attended_hbm_bytes``: ``flops`` and
  ``hbm_bytes`` with the paged kernels' attended work in place of their
  capacity (equal to them when no paged kernel ran; None where a paged
  call's cursors were not read). A share of the card's peak divides
  these, never the capacity count, which at a long ``max_len`` with
  short contexts is many times the work.
* ``peak_bytes``: the peak of the bytes of the storages that ops inside the
  counter allocated and that are still alive (freed when their last tensor
  goes, through a weakref finalizer), the stand-in for XLA's
  ``temp_size_in_bytes``. Tensors made before the counter (the
  parameters, the inputs) and scalars are not in it.

    with CostCounter() as cc:
        loss = step(...)
    cc.analyze()
"""

from __future__ import annotations

import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the reference's collective kinds (``hlo_analysis._COLLECTIVES``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

def _mm(a, b):
    """[.., M, K] @ [.., K, N] as ``2 · result elements · K``."""
    return 2.0 * a.shape[-2] * b.shape[-1] * a.shape[-1] * math.prod(
        a.shape[:-2])


def _sdpa(factor: float):
    """The SDPA ops by their q [B, H, Sq, d] and k [B, H, Sk, d]."""
    def flops(q, k, *rest):
        return factor * math.prod(q.shape[:-1]) * k.shape[-2] * q.shape[-1]
    return flops


#: op packet name → FLOPs of one call from its positional arguments
_FLOPS = {
    "mm": _mm,
    "bmm": _mm,
    "addmm": lambda c, a, b, *r: _mm(a, b),
    "baddbmm": lambda c, a, b, *r: _mm(a, b),
    "addbmm": lambda c, a, b, *r: _mm(a, b),
    "mv": lambda a, v, *r: 2.0 * a.numel(),
    "addmv": lambda c, a, v, *r: 2.0 * a.numel(),
    "dot": lambda a, b, *r: 2.0 * a.numel(),
    "vdot": lambda a, b, *r: 2.0 * a.numel(),
}
for _v in ("flash_attention", "flash_attention_for_cpu",
           "efficient_attention", "cudnn_attention"):
    _FLOPS[f"_scaled_dot_product_{_v}"] = _sdpa(4.0)
    _FLOPS[f"_scaled_dot_product_{_v}_backward"] = (
        lambda g, q, k, *r: _sdpa(8.0)(q, k))

_TO_COPY = torch.ops.aten._to_copy.default

#: ops that move no data
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "_unsafe_view"}


def _tensors(tree) -> list:
    """The tensors of an op's arguments or results (one level of lists)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if not isinstance(tree, (list, tuple)):
        return []
    out = []
    for a in tree:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _kind(func) -> tuple:
    """``(FLOPs rule or None, moves bytes, allocates its results)`` of an
    op: a view moves and allocates nothing, an in-place or ``out=`` op
    writes storage it was given."""
    name = func.overloadpacket.__name__
    view = func.is_view
    return (_FLOPS.get(name), not view and name not in _FREE,
            not view and not func._schema.is_mutable)


class CostCounter(TorchDispatchMode):
    """Counts the work of the ops that run inside it (module docstring).
    ``hidden`` > 0 while a kernel wrapper runs its call: the counter then
    takes the wrapper's report in place of the ops."""

    def __init__(self):
        super().__init__()
        self.hidden = 0
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.kernels: dict[str, dict] = {}
        self.coll_bytes = {k: 0.0 for k in COLLECTIVES}
        self.coll_counts = {k: 0.0 for k in COLLECTIVES}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._tracked: dict[int, int] = {}     # id(storage) -> serial
        self._serial = 0
        self._kinds: dict = {}

    # -- what the kernel wrappers and the gathers report -------------------

    def count_kernel(self, name: str, flops: float, nbytes: int,
                     out, attended=False) -> None:
        """One call of kernel ``name`` with its result ``out``;
        ``attended``: a paged call's attended ``(flops, bytes)``, None
        where unknown, False for a kernel without the split."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        if attended is not False:
            if k["calls"] == 1:
                k["attended_flops"], k["attended_bytes"] = 0.0, 0
            if attended is None or k["attended_flops"] is None:
                k["attended_flops"] = k["attended_bytes"] = None
            else:
                k["attended_flops"] += attended[0]
                k["attended_bytes"] += attended[1]
        self.flops += flops
        self.hbm_bytes += nbytes
        for t in _tensors(out):
            self._track(t)

    def count_collective(self, kind: str, nbytes: int) -> None:
        """One collective of ``nbytes``."""
        self.coll_bytes[kind] += nbytes
        self.coll_counts[kind] += 1

    # -- the ops -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.hidden:
            return out
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _kind(func)
        rule, moves, allocates = kind
        if rule is not None:
            self.flops += rule(*args)
        outs = _tensors(out)
        if moves:
            ins = _tensors(args)
            if kwargs:
                ins += _tensors(list(kwargs.values()))
            if (func is _TO_COPY and outs and ins
                    and outs[0].device != ins[0].device):
                # a host scalar sent to the device: a transfer, not an op
                # on device memory (on the CPU the same ``.to`` is no op)
                return out
            self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        if allocates:
            for t in outs:
                self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        """Add ``t``'s storage to the live bytes if it is new, and take it
        off when it is freed. Scalars are left out: a 0-d loss, count or
        host scalar is noise, and when it goes follows Python's references
        rather than the step."""
        if t.dim() == 0:
            return
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._tracked:
            return
        nbytes = storage.nbytes()
        self._serial += 1
        self._tracked[key] = self._serial
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._free, key, self._serial, nbytes)

    def _free(self, key: int, serial: int, nbytes: int) -> None:
        if self._tracked.get(key) == serial:
            del self._tracked[key]
            self.live_bytes -= nbytes

    def __exit__(self, *exc):
        # storages still alive after the counter are no longer its concern
        self._tracked.clear()
        return super().__exit__(*exc)

    def _attended(self, key: str, total: float):
        """``total`` with each paged kernel's capacity ``key`` replaced by
        its attended count (None if one is unknown)."""
        for k in self.kernels.values():
            if "attended_flops" in k:
                if k["attended_flops"] is None:
                    return None
                total += k[f"attended_{key}"] - k[key]
        return total

    def analyze(self) -> dict:
        """The reference's ``analyze()`` keys, with the port's ``kernels``,
        ``attended_*`` and ``peak_bytes``."""
        return {"flops": self.flops,
                "collective_bytes": dict(self.coll_bytes),
                "collective_counts": dict(self.coll_counts),
                "collective_total_bytes": float(sum(
                    self.coll_bytes.values())),
                "hbm_bytes": self.hbm_bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "attended_flops": self._attended("flops", self.flops),
                "attended_hbm_bytes": self._attended("bytes",
                                                     self.hbm_bytes),
                "peak_bytes": self.peak_bytes}
