"""Checkpoints in the JAX reference's npz + path-manifest format: weight
carry-over and training checkpoints (see ``checkpoint.py``)."""

from repro_torch.checkpoint.checkpoint import (flatten_paths, latest_step,
                                               load_reference_npz,
                                               params_from_numpy, restore,
                                               retain, save,
                                               unflatten_paths)

__all__ = ["flatten_paths", "latest_step", "load_reference_npz",
           "params_from_numpy", "restore", "retain", "save",
           "unflatten_paths"]
