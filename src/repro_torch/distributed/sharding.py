"""Tensor-parallel serving, and the training sharding rules as specs.

The JAX package's ``distributed/sharding.py`` in two halves.

*The training rules, as specs* (the end of this module): the logical-axis
rules (:func:`default_rules`, :func:`activate`, :func:`resolve`), the
parameter table :data:`_PARAM_RULES` with its ``M:`` expert keys, and the
spec trees of parameters (:func:`param_spec_tree`), of the ZeRO-sharded
optimizer state (:func:`zero_spec_tree`), of a batch
(:func:`batch_spec_for`) and of the decode caches
(:func:`cache_spec_tree`). A spec is a plain tuple, one mesh axis name (or
tuple of names, or None) per dimension, resolved against a
:class:`repro_torch.launch.mesh.Mesh` of axis names and sizes. The dry run
(``launch.dryrun``) divides each leaf by them, and
``distributed.placement`` places the training state by them on a placed
mesh (the train step's ZeRO slices; its own module, beside this one). The
reference's ``shard_hint`` has no counterpart: the port has no
partitioner, and its model code places nothing by hints.

*The serving half*, its semantics rather than its mechanism. The reference serves over a ``(1,
tp)`` device mesh whose "model" axis carries every weight's output
dimension, while its serve rules force every activation back to replicated
at each reduction boundary; no floating-point sum ever spans shards, so
tensor-parallel greedy decode is bitwise identical to single-device decode.

Here one process and one engine hold ``tp`` shards of every
column-parallel weight and of the KV pool, shard ``i`` on mesh device
``i`` (shards may share a device: the tests run ``tp`` shards on the CPU,
``chip_smoke.py`` on one card):

* a column-parallel site (:data:`_SERVE_PARAM_RULES`) runs one launch per
  shard on its own output columns and gathers them (:func:`parallel_linear`;
  a batched expert site runs ``E / tp`` experts per shard and gathers the
  experts, so the MoE combine runs after the gather, as the reference's
  ``moe_out -> None``). On one device the gather is a ``torch.cat``, across
  cards a peer copy, never an add; each reports its gathered bytes to the
  active cost counters as an all-gather. The bias is added after the
  gather;
* attention runs per shard on its own query and KV heads against its own
  shard of the pool (:func:`head_parallel`); everything else (embedding,
  norms, router, the Mamba-2 internals, the sampler) runs replicated on the
  engine's device;
* a shard's MVM launch runs the plan of the whole site
  (``kernels.dispatch.whole_site``), so it sums K in the whole launch's
  order, and each column's bits do not depend on how many columns the
  launch computes.

:class:`Shards` is the leaf type of a sharded tensor: the slices and their
split axis, with the handful of in-place tensor methods the engine applies
to cache leaves (row selects, copies, zeroing), each applied to every
shard.

Three of the reference's gating reasons come from GSPMD's inability to
partition a ``pallas_call`` (``use_pallas``, ``partition_safe`` and the
packed-int4 drafter). Here each shard launches its own kernel on its own
columns and heads, so no partitioner is involved: those reasons have no
counterpart in the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.kernels import cost, dispatch
from repro_torch.launch.mesh import indexed


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """The devices of a tensor-parallel engine: shard ``i`` lives on
    ``devices[i]`` (a device may repeat)."""

    devices: tuple

    @property
    def tp(self) -> int:
        """Shards per sharded weight and pool leaf."""
        return len(self.devices)


def available_devices(device) -> list:
    """The devices a mesh may take by default: every CUDA device for an
    engine on the card, the one device otherwise (the CPU is one device;
    shards that share it are asked for explicitly)."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def serve_mesh(tp: int, devices: Optional[Sequence] = None) -> ServeMesh:
    """A mesh of ``tp`` shards: on ``devices`` (``tp`` entries, which may
    repeat), or by default on the first ``tp`` cards."""
    if devices is None:
        devices = available_devices("cuda")[:tp]
    devices = tuple(indexed(d) for d in devices)
    if len(devices) != tp:
        raise ValueError(f"a tp={tp} mesh needs {tp} devices, got "
                         f"{len(devices)}")
    return ServeMesh(devices)


# ---------------------------------------------------------------------------
# the sharded leaf
# ---------------------------------------------------------------------------

class Shards:
    """One logical tensor as equal slices along ``axis`` (negative), slice
    ``i`` on mesh device ``i``. Leading-axis indexing and the engine's
    in-place row operations act on every slice; the split axis itself is
    never indexed."""

    __slots__ = ("parts", "axis")

    def __init__(self, parts: Sequence[torch.Tensor], axis: int):
        self.parts = list(parts)
        self.axis = axis

    @property
    def shape(self) -> torch.Size:
        """The logical (gathered) shape."""
        s = list(self.parts[0].shape)
        s[self.axis] = sum(p.shape[self.axis] for p in self.parts)
        return torch.Size(s)

    @property
    def ndim(self) -> int:
        return self.parts[0].dim()

    def dim(self) -> int:
        return self.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """The device of shard 0."""
        return self.parts[0].device

    def _lead(self, d: int) -> int:
        """``d`` as a leading axis (one before the split axis)."""
        d = d % self.ndim
        if d >= self.ndim + self.axis:
            raise IndexError(f"axis {d} is not a leading axis of a tensor "
                             f"split on axis {self.axis}")
        return d

    def _map(self, fn: Callable) -> "Shards":
        return Shards([fn(p) for p in self.parts], self.axis)

    def __getitem__(self, i) -> "Shards":
        if not isinstance(i, (int, slice)):
            raise IndexError("Shards take an int or a slice of axis 0")
        return self._map(lambda p: p[i])

    def unbind(self, d: int = 0) -> list:
        d = self._lead(d)
        return [Shards(ps, self.axis)
                for ps in zip(*(p.unbind(d) for p in self.parts))]

    def select(self, d: int, i: int) -> "Shards":
        d = self._lead(d)
        return self._map(lambda p: p.select(d, i))

    def index_select(self, d: int, idx: torch.Tensor) -> "Shards":
        d = self._lead(d)
        return self._map(lambda p: p.index_select(d, idx.to(p.device)))

    def index_copy_(self, d: int, idx: torch.Tensor,
                    src: "Shards") -> "Shards":
        d = self._lead(d)
        for p, s in zip(self.parts, src.parts):
            p.index_copy_(d, idx.to(p.device), s)
        return self

    def copy_(self, src) -> "Shards":
        """Copy a Shards slice by slice, or a whole tensor split on the
        axis."""
        srcs = (src.parts if isinstance(src, Shards)
                else _split(src, len(self.parts), self.axis))
        for p, s in zip(self.parts, srcs):
            p.copy_(s)
        return self

    def zero_(self) -> "Shards":
        for p in self.parts:
            p.zero_()
        return self

    def fill_(self, v) -> "Shards":
        for p in self.parts:
            p.fill_(v)
        return self

    def whole(self, device=None) -> torch.Tensor:
        """The gathered tensor on ``device`` (shard 0's by default)."""
        dev = self.device if device is None else device
        return torch.cat([p.to(dev) for p in self.parts], dim=self.axis)


def whole(t):
    """A leaf gathered: a :class:`Shards` joined, anything else as it
    is."""
    return t.whole() if isinstance(t, Shards) else t


def _split(t: torch.Tensor, tp: int, axis: int) -> list:
    return list(torch.chunk(t, tp, dim=axis))


def _shard(t: torch.Tensor, mesh: ServeMesh, axis: int) -> Shards:
    """``t`` split into contiguous slices on the mesh's devices (a slice
    made contiguous where ``t`` lies, then copied)."""
    return Shards([c.contiguous().to(dev)
                   for c, dev in zip(_split(t, mesh.tp, axis),
                                     mesh.devices)], axis)


# ---------------------------------------------------------------------------
# the serve rules
# ---------------------------------------------------------------------------

#: The reference's column-parallel serve table, with its names: every
#: matmul weight shards on its output dimension (the projections back to
#: d_model, ``o`` / ``down`` / ``out_proj``, on d_model: a row-parallel
#: split would need a cross-shard sum), the per-tile device state with its
#: weight's columns, the experts of a MoE site (``M:``) on the expert
#: axis. Everything not listed replicates: norms, biases, the router, the
#: mamba conv and gate norm, the embedding table (a vocab-sharded gather
#: has a ``-0.0`` edge in the reference), input ranges. The port adds the
#: packed-int4 carriers, which split with their columns.
_SERVE_PARAM_RULES = {
    ("qkv", "kernel"): (None, "heads"),
    ("q", "kernel"): (None, "heads"),
    ("k", "kernel"): (None, "heads"),
    ("v", "kernel"): (None, "heads"),
    ("o", "kernel"): (None, "heads"),
    ("gate_up", "kernel"): (None, "mlp"),
    ("up", "kernel"): (None, "mlp"),
    ("down", "kernel"): (None, "mlp"),
    ("M:gate_up", "kernel"): ("experts", None, None),
    ("M:down", "kernel"): ("experts", None, None),
    ("in_proj", "kernel"): (None, "mlp"),
    ("out_proj", "kernel"): (None, "mlp"),
    ("lm_head", "kernel"): (None, "vocab"),
    ("device", "gain"): (None, "mlp"),
    ("device", "nu"): (None, "mlp"),
    ("device", "off"): (None, "mlp"),
    ("device", "dead"): (None, "mlp"),
    ("device", "stuck"): ("mlp",),
    ("M:device", "gain"): ("experts", None, None),
    ("M:device", "nu"): ("experts", None, None),
    ("M:device", "off"): ("experts", None, None),
    ("M:device", "dead"): ("experts", None, None),
    ("M:device", "stuck"): ("experts", None),
    ("int4", "packed"): (None, "mlp"),
    ("int4", "scale"): ("mlp",),
    ("int4", "colmax"): ("mlp",),
    ("M:int4", "packed"): ("experts", None, None),
    ("M:int4", "scale"): ("experts", None),
    ("M:int4", "colmax"): ("experts", None),
}

def _guard(tp: int, shape: tuple, axis: Optional[int]) -> Optional[int]:
    """The reference's ``_guard``: a dimension that does not split evenly
    over ``tp`` stays whole (None)."""
    if axis is None or shape[axis] % tp:
        return None
    return axis


def _rule_axis(site: str, leaf: str, in_moe: bool) -> Optional[int]:
    """The split axis (negative, so leading stack dims do not move it) the
    table gives leaf ``leaf`` of site ``site``, or None. Every named
    logical axis of the table lies on the mesh's model axis under the
    serve rules; every activation axis maps to None (replicated, so
    gathered where a sharded product made it)."""
    key = (f"M:{site}", leaf) if in_moe else None
    if key not in _SERVE_PARAM_RULES:
        key = (site, leaf)
    logical = _SERVE_PARAM_RULES.get(key, ())
    return next((i - len(logical) for i, ax in enumerate(logical) if ax),
                None)


def _device_aligned(dev: dict, n: int, tp: int) -> bool:
    """True when the tile grid of a column-split site divides over the
    shards on tile boundaries: TN splits evenly and the tiles divide N, so
    that shard ``i``'s tiles are exactly the tiles of its columns. A shard
    boundary inside a tile keeps the state whole (each shard then reads
    its columns of the whole grid)."""
    tn = dev["gain"].shape[-1]
    return tn % tp == 0 and n % tn == 0


def _shard_site(site: str, p: dict, in_moe: bool, mesh: ServeMesh) -> dict:
    """One analog site (a dict holding ``kernel``) sharded by the table,
    or returned whole when its kernel does not split. A column split must
    keep each shard's width even where the site's is (the int4 kernel packs
    column pairs), or the site stays whole."""
    tp = mesh.tp
    w = p["kernel"]
    axis = _guard(tp, tuple(w.shape), _rule_axis(site, "kernel", in_moe))
    if axis is None:
        return p
    n = w.shape[-1]
    if axis == -1 and n % 2 == 0 and (n // tp) % 2:
        return p
    out = dict(p, kernel=_shard(w, mesh, axis))
    for sub in ("int4", "device"):
        if sub not in p:
            continue
        d = p[sub]
        if sub == "device" and axis == -1 and not _device_aligned(d, n, tp):
            continue
        out[sub] = dict(d)
        for leaf, v in d.items():
            ax = _guard(tp, tuple(v.shape), _rule_axis(sub, leaf, in_moe))
            if ax is not None:
                out[sub][leaf] = _shard(v, mesh, ax)
    return out


def shard_params_for_serve(mesh: ServeMesh, params: dict) -> dict:
    """A new parameter tree with every column-parallel site sharded over
    ``mesh`` (:class:`Shards` leaves, each slice copied from wherever
    ``params`` lie straight to its device) and every replicated leaf on
    the mesh's first device (shared with ``params`` where it is there
    already). Walks as the reference's ``param_spec_tree``: a site's name
    is its key, and everything under a dict that holds a ``router`` is a
    MoE site (``M:`` rules)."""
    home = mesh.devices[0]

    def walk(node: dict, name: Optional[str], in_moe: bool) -> dict:
        if "kernel" in node and name is not None and name != "router":
            node = _shard_site(name, node, in_moe, mesh)
        moe_here = in_moe or "router" in node
        return {k: walk(v, k, moe_here) if isinstance(v, dict)
                else v.to(home) if isinstance(v, torch.Tensor) else v
                for k, v in node.items()}

    return walk(params, None, False)


def shard_caches_for_serve(mesh: ServeMesh, caches: dict) -> dict:
    """A new cache tree with the attention KV split on its KV heads (the
    reference's cache rules under the serve rules): the paged pools
    ``kp`` / ``vp`` [.., P, bs, KV, hd] and their int8 scales ``ks`` /
    ``vs`` [.., P, bs, KV], and the per-slot buffers ``k`` / ``v`` [.., B,
    T, KV, hd]. Every shard holds ``KV / tp`` heads of every physical
    block, so the block tables, refcounts, radix index and snapshot pools
    stay single and shard-agnostic. The mamba state (``conv``, ``ssm`` and
    their snapshots) replicates, as the reference's ``ssm_heads`` /
    ``ssm_conv -> None``; cursors and tables too."""
    axes = {"kp": -2, "vp": -2, "k": -2, "v": -2, "ks": -1, "vs": -1}

    def walk(node: dict) -> dict:
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in axes and isinstance(v, torch.Tensor):
                ax = _guard(mesh.tp, tuple(v.shape), axes[k])
                out[k] = v if ax is None else _shard(v, mesh, ax)
            else:
                out[k] = v
        return out

    return walk(caches)


def serve_tp_unsupported(cfg, tp: int,
                         devices: Optional[Sequence] = None
                         ) -> Optional[str]:
    """Why ``tp``-way tensor parallelism cannot serve this config, or None
    (the engine then records the reason in ``gating_reasons
    ["tensor_parallel"]`` and serves at tp = 1).

    ``devices`` are those the shards may take (the engine's explicit
    shard devices, or :func:`available_devices`). The reference's reasons
    for too few devices and for heads or KV heads that do not divide are
    kept; its ``use_pallas`` and ``partition_safe`` reasons have no
    counterpart here (see the module docstring), so the deployment is not
    an argument."""
    if tp <= 1:
        return None
    n = len(available_devices("cuda") if devices is None else devices)
    if n < tp:
        return (f"tp={tp} needs {tp} devices, runtime has {n} "
                "(ServeEngine(shard_devices=[...]) places shards that "
                "share a device, as the CPU tests do)")
    if cfg.family in ("dense", "moe", "hybrid"):
        kv = getattr(cfg, "num_kv_heads", 0) or cfg.num_heads
        if cfg.num_heads % tp:
            return (f"num_heads={cfg.num_heads} is not divisible by "
                    f"tp={tp} — attention heads cannot split evenly")
        if kv % tp:
            return (f"num_kv_heads={kv} is not divisible by tp={tp} — "
                    "the per-shard KV pool cannot split the head dim "
                    "evenly")
    return None


# ---------------------------------------------------------------------------
# the model's gathers
# ---------------------------------------------------------------------------

def _on(v, i: int, dev):
    """Shard ``i``'s view of a leaf: its slice, or the replicated leaf on
    ``dev``."""
    if isinstance(v, Shards):
        return v.parts[i]
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    if isinstance(v, dict):
        return {k: _on(x, i, dev) for k, x in v.items()}
    return v


def parallel_linear(linear: Callable, p: dict, x: torch.Tensor, cfg, ctx):
    """``linear(p, x, cfg, ctx)`` (``core.analog.analog_linear``) of a
    sharded site: one call per shard on its columns (kernel split on the
    last axis; ``x`` replicated) or on its experts (a batched ``[E, K, N]``
    kernel split on E; ``x`` [E, ..., K] split with it), each under the
    whole site's launch plan, gathered on ``x``'s device; the bias is added
    after the gather. Returns ``(y, stats)`` (shard 0's stats: serving
    collects none)."""
    w = p["kernel"]
    tp, home = len(w.parts), x.device
    experts = w.axis == -3
    e = w.shape[-3] if w.ndim >= 3 else 1
    n = w.shape[-1]
    cols = (not experts and "device" in p
            and not isinstance(p["device"]["gain"], Shards))
    outs, stats = [], None
    for i in range(tp):
        dev = w.parts[i].device
        sub = {k: _on(v, i, dev) for k, v in p.items() if k != "bias"}
        if cols:                      # the whole grid, read at its columns
            sub["cols"] = (i * (n // tp), n)
        xi = x
        if experts:
            xi = x[i * (e // tp):(i + 1) * (e // tp)]
        first = (i * (e // tp), 0) if experts else (0, i * (n // tp))
        with dispatch.whole_site(e, n, *first):
            y, st = linear(sub, xi.to(dev), cfg, ctx)
        outs.append(y.to(home))
        stats = st if stats is None else stats
    y = torch.cat(outs, dim=0 if experts else -1)
    cost.collective("all-gather", y.numel() * y.element_size())
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y, stats


def is_sharded(cache: Optional[dict]) -> bool:
    """True when an attention cache's KV leaves are sharded."""
    return cache is not None and any(isinstance(v, Shards)
                                     for v in cache.values())


def head_parallel(attend: Callable, cache: dict, q: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor):
    """``attend(cache, q, k, v) -> (out, new_cache)`` over a sharded
    attention cache: shard ``i`` takes its ``H / tp`` query heads and
    ``KV / tp`` KV heads (contiguous ranges, so each GQA group stays on one
    shard) against its own KV slices; the outputs are gathered on the
    head axis on ``q``'s device. The new cache keeps the sharded leaves
    (written in place) and shard 0's cursors."""
    tp = next(len(x.parts) for x in cache.values() if isinstance(x, Shards))
    devs = [next(x.parts[i].device for x in cache.values()
                 if isinstance(x, Shards)) for i in range(tp)]
    hq, hkv = q.shape[-2] // tp, k.shape[-2] // tp
    home = q.device
    outs, first = [], None
    for i, dev in enumerate(devs):
        sub = {name: _on(x, i, dev) for name, x in cache.items()}
        out, new = attend(sub, q[..., i * hq:(i + 1) * hq, :].to(dev),
                          k[..., i * hkv:(i + 1) * hkv, :].to(dev),
                          v[..., i * hkv:(i + 1) * hkv, :].to(dev))
        outs.append(out.to(home))
        first = new if first is None else first
    new_cache = {name: (cache[name] if isinstance(cache[name], Shards)
                        else x.to(home) if isinstance(x, torch.Tensor)
                        else x)
                 for name, x in first.items()}
    out = torch.cat(outs, dim=-2)
    cost.collective("all-gather", out.numel() * out.element_size())
    return out, new_cache


# ---------------------------------------------------------------------------
# the training rules, as specs
# ---------------------------------------------------------------------------

_state = threading.local()


def _active() -> Optional[dict]:
    """The thread-local active ``{"mesh", "rules"}`` context, or None."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def activate(mesh, rules: dict[str, Any]):
    """Resolve specs against ``mesh`` (a ``launch.mesh.Mesh``) and
    ``rules`` inside the block."""
    prev = _active()
    _state.ctx = {"mesh": mesh, "rules": dict(rules)}
    try:
        yield
    finally:
        _state.ctx = prev


def default_rules(mesh, *, batch_shardable: bool = True,
                  seq_shard_kv: bool = False) -> dict[str, Any]:
    """The reference's logical-axis → mesh-axis mapping for the standard
    mesh: batch over ``("pod", "data")`` where it divides, heads / mlp /
    vocab / experts over "model", the KV sequence over "data" only when
    the batch cannot be sharded (``long_500k``), the ZeRO state over
    "data". The activation axes are kept for the rules' sake; the port
    places no activation by them."""
    pod = ("pod",) if "pod" in mesh.axis_names else ()
    return {
        "batch": pod + ("data",) if batch_shardable else None,
        "heads": "model",
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "moe_buf": "model",
        "embed": None,
        "seq": None,
        "kv_seq": ("data",) if seq_shard_kv else None,
        "kv_seq_model": "model",
        "zero": "data",
        "attn_out": "model",
        "mlp_act": "model",
        "moe_out": "model",
        "ssm_heads": "model",
        "ssm_conv": "model",
        "serve_act": "skip",
    }


def serve_rules(mesh) -> dict[str, Any]:
    """The reference's serve rules: weights over "model", every activation
    axis replicated, and the ``"__serve_params__"`` marker that switches
    :func:`param_spec_tree` onto :data:`_SERVE_PARAM_RULES`."""
    del mesh
    return {
        "batch": None, "seq": None, "kv_seq": None, "kv_seq_model": None,
        "heads": "model", "mlp": "model", "vocab": "model",
        "experts": "model", "moe_buf": "model", "attn_out": None,
        "mlp_act": None, "moe_out": None, "serve_act": None,
        "ssm_heads": None, "ssm_conv": None, "embed": None, "zero": None,
        "__serve_params__": True,
    }


def _axis_size(mesh, axis) -> int:
    """Devices along a mesh axis name, or the product over a tuple of
    names (1 for None)."""
    if axis is None:
        return 1
    shape = mesh.shape
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= shape.get(a, 1)
        return n
    return shape.get(axis, 1)


def _guard_spec(mesh, shape: tuple, axes: tuple) -> tuple:
    """The reference's ``_guard`` (named apart from the serve side's
    :func:`_guard`): an axis whose extent does not divide its dimension
    replicates (None), and a mesh axis maps to at most one dimension."""
    out, used = [], set()
    for dim, ax in zip(shape, axes):
        names = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
        if (ax is None or dim % _axis_size(mesh, ax) != 0
                or any(n in used for n in names)):
            out.append(None)
        else:
            out.append(ax)
            used.update(names)
    return tuple(out)


def resolve(logical: tuple, shape: tuple | None = None) -> tuple:
    """Logical axes → a spec under the active context (guarded against
    ``shape`` when given)."""
    ctx = _active()
    if ctx is None:
        raise RuntimeError("resolve needs an active mesh (activate)")
    axes = tuple(ctx["rules"].get(ax) if ax is not None else None
                 for ax in logical)
    if shape is not None:
        axes = _guard_spec(ctx["mesh"], shape, axes)
    return axes


#: The reference's training table: (site, leaf) → logical axes of the
#: rightmost dimensions (leading stacked-layer dimensions replicate).
#: ``M:`` keys are a MoE site's experts: the expert axis maps to "model",
#: and d_ff stays whole (a mesh axis maps to one dimension only).
_PARAM_RULES = {
    ("qkv", "kernel"): (None, "heads"),
    ("qkv", "bias"): ("heads",),
    ("q", "kernel"): (None, "heads"),
    ("q", "bias"): ("heads",),
    ("k", "kernel"): (None, "heads"),
    ("k", "bias"): ("heads",),
    ("v", "kernel"): (None, "heads"),
    ("v", "bias"): ("heads",),
    ("o", "kernel"): ("heads", None),
    ("gate_up", "kernel"): (None, "mlp"),
    ("up", "kernel"): (None, "mlp"),
    ("up", "bias"): ("mlp",),
    ("down", "kernel"): ("mlp", None),
    ("down", "bias"): (None,),
    ("M:gate_up", "kernel"): ("experts", None, None),
    ("M:down", "kernel"): ("experts", None, None),
    ("router", "kernel"): (None, None),
    ("in_proj", "kernel"): (None, "mlp"),
    ("out_proj", "kernel"): ("mlp", None),
    ("conv_w", None): (None, "mlp"),
    ("conv_b", None): ("mlp",),
    ("gate_norm", None): ("mlp",),
    ("a_log", None): (None,),
    ("d_skip", None): (None,),
    ("dt_bias", None): (None,),
    ("tokens", None): ("vocab", None),
    ("codebooks", None): (None, "vocab", None),
    ("lm_head", "kernel"): (None, "vocab"),
    ("projector", "kernel"): (None, None),
}


def _walk_specs(params, leaf_fn):
    """``leaf_fn(site, leaf, value, in_moe)`` over a parameter tree, with
    the reference's walk: a leaf's site is the key of its dict, and a dict
    holding a ``router`` makes everything below it a MoE site."""
    def walk(node, site, in_moe):
        if isinstance(node, dict):
            moe_here = in_moe or "router" in node
            return {k: walk(v, k, moe_here) if isinstance(v, dict)
                    else leaf_fn(site, k, v, moe_here)
                    for k, v in node.items()}
        return leaf_fn(site, None, node, in_moe)
    return walk(params, None, False)


def param_spec_tree(params) -> Any:
    """The spec tree of a parameter tree under the active rules (the serve
    table under :func:`serve_rules`)."""
    return _walk_specs(params, _leaf_spec)


def _leaf_spec(site, leaf, value, in_moe) -> tuple:
    """The spec of one named parameter leaf; () replicates it (norms,
    scalars, input ranges)."""
    ctx = _active()
    rules = ctx["rules"]
    table = (_SERVE_PARAM_RULES if rules.get("__serve_params__")
             else _PARAM_RULES)
    key = None
    if site is not None:
        prefixed = (f"M:{site}", leaf) if in_moe else None
        if prefixed in table:
            key = prefixed
        elif (site, leaf) in table:
            key = (site, leaf)
    if key is None and (leaf, None) in table:
        key = (leaf, None)
    if key is None and (site, None) in table:
        key = (site, None)
    if key is None:
        return ()
    logical = table[key]
    pad = (None,) * (value.dim() - len(logical))
    axes = pad + tuple(rules.get(ax) if ax is not None else None
                       for ax in logical)
    return _guard_spec(ctx["mesh"], tuple(value.shape), axes)


def zero_spec_tree(params) -> Any:
    """The optimizer moments' specs (ZeRO-1/2): each parameter's spec with
    the "zero" axis on its first free dimension that the data axis
    divides."""
    ctx = _active()
    mesh = ctx["mesh"]
    dsize = mesh.shape.get("data", 1)

    def upgrade(site, leaf, p, in_moe):
        spec = _leaf_spec(site, leaf, p, in_moe)
        if p.dim() == 0 or dsize == 1:
            return spec
        parts = list(spec) + [None] * (p.dim() - len(spec))
        for i, ax in enumerate(parts):
            if ax is None and p.shape[i] % dsize == 0 and p.shape[i] >= dsize:
                parts[i] = ctx["rules"].get("zero")
                break
        return _guard_spec(mesh, tuple(p.shape), tuple(parts))

    return _walk_specs(params, upgrade)


def batch_spec(ndim: int) -> tuple:
    """The batch axis on the first dimension, the rest replicated."""
    b = _active()["rules"].get("batch")
    return (b,) + (None,) * (ndim - 1)


def batch_spec_for(shape: tuple) -> tuple:
    """:func:`batch_spec`, guarded against a batch that does not divide."""
    ctx = _active()
    return _guard_spec(ctx["mesh"], tuple(shape), batch_spec(len(shape)))


def cache_spec_tree(caches) -> Any:
    """The decode caches' specs: KV ``k`` / ``v`` [.., B, T, KV, hd] on
    (batch, kv_seq, heads, None) where the heads divide the model axis,
    else on (batch, kv_seq_model, None, None); the paged pools ``kp`` /
    ``vp`` and their int8 scales on their KV heads; the SSM state [.., B,
    H, N, P] on (batch, ssm_heads, None, None); the conv tail [.., B, W-1,
    C] on (batch, None, ssm_conv). Leading stacked dimensions replicate,
    and so do the tables, cursors and snapshot pools (a cursor that is a
    host int has the spec ())."""
    ctx = _active()
    rules, mesh = ctx["rules"], ctx["mesh"]
    hsize = _axis_size(mesh, rules.get("heads"))

    def leaf(name, x):
        if not isinstance(x, torch.Tensor):
            return ()
        if name in ("k", "v"):
            logical = (("batch", "kv_seq", "heads", None)
                       if x.shape[-2] % hsize == 0
                       else ("batch", "kv_seq_model", None, None))
        elif name in ("kp", "vp"):
            logical = (("heads", None) if x.shape[-2] % hsize == 0
                       else (None, None))
        elif name in ("ks", "vs"):
            logical = ("heads",) if x.shape[-1] % hsize == 0 else (None,)
        elif name == "ssm":
            logical = ("batch", "ssm_heads", None, None)
        elif name == "conv":
            logical = ("batch", None, "ssm_conv")
        else:
            return ()
        pad = (None,) * (x.dim() - len(logical))
        axes = pad + tuple(rules.get(ax) if ax else None for ax in logical)
        return _guard_spec(mesh, tuple(x.shape), axes)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in node.items()}

    return walk(caches)


def shard_bytes(x: torch.Tensor, spec: tuple, mesh) -> int:
    """Bytes of one device's shard of ``x`` under ``spec``."""
    n = x.numel() * x.element_size()
    for ax in spec:
        n //= _axis_size(mesh, ax)
    return n
