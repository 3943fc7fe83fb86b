"""Weight carry-over from the JAX reference (see ``checkpoint.py``)."""

from repro_torch.checkpoint.checkpoint import (flatten_paths,
                                               load_reference_npz,
                                               params_from_numpy,
                                               unflatten_paths)

__all__ = ["flatten_paths", "load_reference_npz", "params_from_numpy",
           "unflatten_paths"]
