"""Production and host meshes: axis names and sizes, and their devices.

The counterpart of the JAX package's ``launch/mesh.py``. The port has no
partitioner, so a mesh here is first its shape: the axis names and their
sizes, which the training specs of ``distributed.sharding`` resolve
against and the dry run (``launch.dryrun``) divides each leaf by. Making
one touches no device, and importing this module touches none either
(the reference's dry-run contract).

A mesh may also be *placed*: given ``devices``, a flat row-major tuple
over its positions (position ``(i, j)`` of a ``("data", "model")`` mesh is
``devices[i * model + j]``; a device may repeat, as in
``distributed.sharding.ServeMesh``). ``distributed.placement`` puts the
training state on a placed mesh, one slice per position, and the train
step runs its data shards there. :func:`place_mesh` is the counterpart of
``jax.make_mesh``: with fewer visible cards than the mesh needs, it
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh: ``axis_names[i]`` has ``axis_sizes[i]`` devices, and
    ``devices`` (None for a mesh by shape alone) holds the device of each
    position, row-major."""

    axis_names: tuple
    axis_sizes: tuple
    devices: Optional[tuple] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} and {self.axis_sizes} "
                             "differ in length")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a mesh of {self.size} positions was given "
                             f"{len(self.devices)} devices")

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Devices in the mesh."""
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    @property
    def placed(self) -> bool:
        """True when the mesh has its devices."""
        return self.devices is not None

    def device_at(self, pos: dict) -> torch.device:
        """The device of the position ``{axis name: index}`` (an axis left
        out is at 0)."""
        flat = 0
        for name, size in zip(self.axis_names, self.axis_sizes):
            flat = flat * size + pos.get(name, 0)
        return self.devices[flat]


def indexed(device) -> torch.device:
    """``device`` as a device, ``cuda`` as the current card's ``cuda:i``
    (the device a tensor made there reports)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def place_mesh(mesh: Mesh, devices: Optional[Sequence] = None) -> Mesh:
    """``mesh`` on ``devices`` (one per position, row-major; they may
    repeat), or by default on the first ``mesh.size`` visible cards.
    Raises ``ValueError`` naming both counts when fewer cards are visible
    than the mesh needs."""
    if devices is None:
        n = torch.cuda.device_count()
        if n < mesh.size:
            raise ValueError(f"the {dict(mesh.shape)} mesh needs "
                             f"{mesh.size} devices, {n} are visible")
        devices = [torch.device("cuda", i) for i in range(mesh.size)]
    devices = tuple(indexed(d) for d in devices)
    if len(devices) != mesh.size:
        raise ValueError(f"the {dict(mesh.shape)} mesh needs {mesh.size} "
                         f"devices, {len(devices)} were given")
    return dataclasses.replace(mesh, devices=devices)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 ``("data", "model")`` (256 devices), or 2 x 16 x 16
    ``("pod", "data", "model")`` (512), by shape (:func:`place_mesh`
    gives it its cards).

    ``data`` carries the batch (and the ZeRO sharding of the training
    state), ``model`` the tensor and expert parallelism, ``pod`` the
    cross-pod data parallelism."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(model: int = 1,
                   devices: int | Sequence | None = None) -> Mesh:
    """A ``(n / model, model)`` ``("data", "model")`` mesh. By default it
    is placed over the visible cards (``n = torch.cuda.device_count()``);
    given a device list it is placed over that list (``n`` its length;
    devices may repeat); given a count it is a mesh by shape alone (the
    dry run and its tools pass the count)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = devices if isinstance(devices, int) else len(devices)
    if n < 1 or n % model:
        raise ValueError(f"{n} devices do not split into a model axis of "
                         f"{model}")
    mesh = Mesh(("data", "model"), (n // model, model))
    return mesh if isinstance(devices, int) else place_mesh(mesh, devices)
