"""Production and host meshes, as axis names and sizes.

The counterpart of the JAX package's ``launch/mesh.py``. The port has no
partitioner, so a mesh here is only its shape: the axis names and their
sizes, which the training specs of ``distributed.sharding`` resolve
against and the dry run (``launch.dryrun``) divides each leaf by. Making
one touches no device, and importing this module touches none either
(the reference's dry-run contract).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh by shape alone: ``axis_names[i]`` has
    ``axis_sizes[i]`` devices."""

    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} and {self.axis_sizes} "
                             "differ in length")

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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 ``("data", "model")`` (256 devices), or 2 x 16 x 16
    ``("pod", "data", "model")`` (512).

    ``data`` carries the batch (and the ZeRO sharding of the training
    state), ``model`` the tensor and expert parallelism, ``pod`` the
    cross-pod data parallelism."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(model: int = 1, devices: int | None = None) -> Mesh:
    """A ``(devices / model, model)`` ``("data", "model")`` mesh over the
    local cards (``torch.cuda.device_count()``), or over ``devices`` when
    given (the tests and the dry run pass the count)."""
    n = torch.cuda.device_count() if devices is None else devices
    if n < 1 or n % model:
        raise ValueError(f"{n} devices do not split into a model axis of "
                         f"{model}")
    return Mesh(("data", "model"), (n // model, model))
