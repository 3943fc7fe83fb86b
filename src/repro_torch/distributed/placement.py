"""Training state placed by the training specs (ZeRO), under one
controller: the training half of the JAX package's ``distributed``
package.

In the reference the placement is GSPMD's: the train step is the global
step, and ``param_spec_tree`` / ``zero_spec_tree`` / ``batch_spec_for``
only say where each array lives. The port has no partitioner, so it
writes the same semantics with one controller, as the serving half
(``distributed.sharding``) does: a leaf placed on a placed mesh
(``launch.mesh.place_mesh``) is a :class:`Placed`, the slice of every
mesh position on that position's device. A spec may split one dimension
or two (data × model), and a dimension on a tuple of axes (``("pod",
"data")``) splits over their row-major product.

:class:`Placed` is a leaf type of its own beside ``sharding.Shards``:
``Shards`` is one split axis with the engine's in-place row operations;
a training leaf needs a grid of slices and nothing in place. Positions
that hold the same slice on the same device share one tensor, so shards
that share a device (the CPU tests, one card) hold one copy of a
replicated slice, and a leaf that a spec leaves whole on its own device
is held by reference: on a one-position mesh placing and gathering copy
nothing.

:func:`gather` (the inverse of :func:`place`, bit for bit) and
:func:`reduce_scatter` report their bytes to the active cost counters
(``kernels.cost.collective``): an all-gather its gathered tensor, a
reduce-scatter one position's slice (each collective's output, as the
reference's HLO count has it). On one device a gather is copies, across
cards peer copies; nothing here sums.

A 0-dim tensor (the step count, the moments' ``count``) and a non-tensor
leaf stay as they are.
"""

from __future__ import annotations

import itertools
from typing import Callable

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import cost


def _axes(entry) -> tuple:
    """The mesh axis names of one spec entry (None → ())."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _positions(mesh) -> list:
    """Every mesh position as ``{axis: index}``, row-major (the order of
    ``mesh.devices``)."""
    return [dict(zip(mesh.axis_names, idx)) for idx in
            itertools.product(*(range(s) for s in mesh.axis_sizes))]


def _block(mesh, spec: tuple, pos: dict) -> tuple:
    """The slice index along each dimension of the position ``pos``: the
    row-major index of its coordinates on that dimension's axes."""
    out = []
    for entry in spec:
        i = 0
        for ax in _axes(entry):
            i = i * mesh.shape[ax] + pos[ax]
        out.append(i)
    return tuple(out)


def _grid(mesh, spec: tuple) -> tuple:
    """Slices along each dimension."""
    return tuple(shd._axis_size(mesh, e) if _axes(e) else 1 for e in spec)


class Placed:
    """One logical tensor placed on a mesh by ``spec``: ``parts[f]`` is
    the slice of mesh position ``f`` (row-major) on that position's
    device."""

    __slots__ = ("parts", "spec", "mesh", "shape")

    def __init__(self, parts, spec: tuple, mesh, shape):
        self.parts = list(parts)
        self.spec = tuple(spec)
        self.mesh = mesh
        self.shape = torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """The device of position 0."""
        return self.parts[0].device

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return self.ndim

    def numel(self) -> int:
        return self.shape.numel()

    def element_size(self) -> int:
        return self.parts[0].element_size()

    def blocks(self) -> dict:
        """``{slice index: first position holding it}``, in grid order."""
        firsts = {}
        for f, pos in enumerate(_positions(self.mesh)):
            firsts.setdefault(_block(self.mesh, self.spec, pos), f)
        return dict(sorted(firsts.items()))

    def whole(self, device=None) -> torch.Tensor:
        """The logical tensor on ``device`` (position 0's by default),
        each slice copied into its place, or the one slice itself where it
        is the whole tensor on ``device`` (reports nothing: :func:`gather`
        is the collective)."""
        dev = self.device if device is None else torch.device(device)
        blocks = self.blocks()
        if len(blocks) == 1 and self.parts[0].device == dev:
            return self.parts[0]
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        grid = _grid(self.mesh, self.spec)
        for blk, f in blocks.items():
            dst = out
            for d, (b, n) in enumerate(zip(blk, grid)):
                if n > 1:
                    size = self.shape[d] // n
                    dst = dst.narrow(d, b * size, size)
            dst.copy_(self.parts[f])
        return out


def _slice(x: torch.Tensor, blk: tuple, grid: tuple) -> torch.Tensor:
    """Slice ``blk`` of ``x`` on the ``grid`` (a view)."""
    for d, (b, n) in enumerate(zip(blk, grid)):
        if n > 1:
            size = x.shape[d] // n
            x = x.narrow(d, b * size, size)
    return x


def _spread(mesh, spec: tuple, shape, made: Callable) -> Placed:
    """A :class:`Placed` whose slice ``blk`` on device ``dev`` is
    ``made(blk, dev)``, computed once per (slice, device)."""
    cache, parts = {}, []
    for f, pos in enumerate(_positions(mesh)):
        key = (_block(mesh, spec, pos), mesh.devices[f])
        if key not in cache:
            cache[key] = made(*key)
        parts.append(cache[key])
    return Placed(parts, spec, mesh, shape)


def place(x: torch.Tensor, spec: tuple, mesh) -> Placed:
    """``x`` placed on the (placed) ``mesh`` by ``spec``: each position
    gets a fresh contiguous copy of its slice on its device, or ``x``
    itself where the spec leaves it whole and it lies there already (a
    one-position mesh places by reference: the step makes new tensors and
    changes none in place)."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    grid = _grid(mesh, spec)
    whole = all(n == 1 for n in grid)

    def made(blk, dev):
        if whole and x.device == dev:
            return x
        src = _slice(x, blk, grid)
        return torch.empty(src.shape, dtype=x.dtype, device=dev).copy_(src)
    return _spread(mesh, spec, x.shape, made)


def gather(t, device=None):
    """A :class:`Placed` leaf whole on ``device`` (position 0's by
    default), reported as one all-gather of its bytes where it has more
    than one slice; any other leaf as it is (moved to ``device`` when
    given)."""
    if isinstance(t, Placed):
        if len(t.blocks()) > 1:
            cost.collective("all-gather", t.numel() * t.element_size())
        return t.whole(device)
    if device is not None and isinstance(t, torch.Tensor):
        return t.to(device)
    return t


def _placeable(x) -> bool:
    return isinstance(x, (torch.Tensor, Placed)) and x.dim() > 0


def place_tree(tree, specs, mesh):
    """Every placeable leaf of ``tree`` placed by its spec in ``specs``
    (a leaf already placed so is kept; one placed otherwise is gathered
    and placed again). With no mesh (None) every placed leaf is gathered
    whole and the rest kept."""
    if mesh is None:
        return gather_tree(tree)
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if not _placeable(tree):
        return tree
    spec = tuple(specs) + (None,) * (tree.dim() - len(specs))
    if isinstance(tree, Placed):
        if tree.mesh == mesh and tree.spec == spec:
            return tree
        tree = gather(tree, mesh.devices[0])
    return place(tree, spec, mesh)


def gather_tree(tree, device=None):
    """Every :class:`Placed` leaf of ``tree`` (dicts and tuples of leaves)
    gathered (:func:`gather`)."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(gather_tree(v, device) for v in tree)
    return gather(tree, device)


def to_device(tree, device):
    """``tree`` with every tensor leaf on ``device`` (shared where it is)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def specs_for(tree, *, zero: bool = True):
    """The spec tree of ``tree`` under the active rules: the ZeRO specs
    (``zero_spec_tree``) or the tensor-parallel ones
    (``param_spec_tree``)."""
    return (shd.zero_spec_tree(tree) if zero
            else shd.param_spec_tree(tree))


def place_by(tree, mesh, rules=None, *, zero: bool = True):
    """``tree`` placed on ``mesh`` by its ZeRO (or tensor-parallel) specs
    under ``rules`` (``default_rules(mesh)`` by default)."""
    with shd.activate(mesh, rules or shd.default_rules(mesh)):
        return place_tree(tree, specs_for(tree, zero=zero), mesh)


def reduce_scatter(tree, specs, mesh):
    """A tree of summed whole tensors scattered to its slices (the
    reduce-scatter's scatter half: the step has summed), each split leaf
    reported as one reduce-scatter of a position's slice (with no mesh,
    the tree as it is)."""
    out = place_tree(tree, specs, mesh)
    for leaf in _leaves(out):
        if isinstance(leaf, Placed) and len(leaf.blocks()) > 1:
            cost.collective("reduce-scatter",
                            leaf.parts[0].numel() * leaf.element_size())
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def map_leaf(fn: Callable, *leaves):
    """``fn`` over the distinct slices of ``leaves`` (placed alike): ``fn``
    takes one list of slices (grid order, each on the device of the first
    position holding it) per leaf and returns a list of output slices, or
    a tuple of such lists; each output is placed like ``leaves[0]``. A
    leaf left whole (0-dim) is its one slice."""
    like = leaves[0]
    if not isinstance(like, Placed):
        outs = fn(*[[x] for x in leaves])
        return (tuple(o[0] for o in outs) if isinstance(outs, tuple)
                else outs[0])
    firsts = like.blocks()
    outs = fn(*[[x.parts[f] for f in firsts.values()] for x in leaves])
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    placed = []
    for out in outs:
        by_blk = dict(zip(firsts, out))
        placed.append(_spread(like.mesh, like.spec, like.shape,
                              lambda blk, dev: by_blk[blk].to(dev)))
    return placed[0] if single else tuple(placed)


def active_mesh():
    """The active mesh when it is placed, else None (the train step then
    runs unsharded)."""
    ctx = shd._active()
    if ctx is None or not getattr(ctx["mesh"], "placed", False):
        return None
    return ctx["mesh"]


def data_devices(mesh, spec: tuple) -> list:
    """The device of each data shard of a batch whose leading dimension
    has ``spec[0]``: shard ``i`` (row-major over the batch's axes) at the
    position with those coordinates and every other axis at 0; one shard
    on position 0's device when the batch is not split."""
    axes = _axes(spec[0]) if spec else ()
    sizes = [mesh.shape[a] for a in axes]
    return [mesh.device_at(dict(zip(axes, idx)))
            for idx in itertools.product(*(range(s) for s in sizes))]


def split_batch(batch: dict, mesh, dim: int = 0) -> list:
    """``[(device, shard batch)]``: each leaf's rows along ``dim`` (1 for a
    microbatched ``[A, mb, ...]`` batch) split into contiguous equal
    blocks by ``batch_spec_for``, block ``i`` on data shard ``i``'s
    device; with no mesh (None) one shard, the batch where it lies."""
    tokens = batch["tokens"]
    if mesh is None:
        return [(tokens.device, batch)]
    spec = shd.batch_spec_for(tuple(tokens.shape[dim:]))
    devs = data_devices(mesh, spec)
    n = len(devs)
    return [(dev, {k: v.narrow(dim, i * (v.shape[dim] // n),
                               v.shape[dim] // n).to(dev)
                   for k, v in batch.items()})
            for i, dev in enumerate(devs)]


def position_bytes(tree) -> list:
    """Bytes each mesh position holds of the :class:`Placed` leaves of
    ``tree`` (a position's slices; other leaves are not counted)."""
    total = None
    for leaf in _leaves(tree):
        if isinstance(leaf, Placed):
            nb = [p.numel() * p.element_size() for p in leaf.parts]
            total = nb if total is None else [a + b
                                              for a, b in zip(total, nb)]
    return total or [0]


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree``, whole."""
    return sum(x.numel() * x.element_size() for x in _leaves(tree)
               if isinstance(x, (torch.Tensor, Placed)))
