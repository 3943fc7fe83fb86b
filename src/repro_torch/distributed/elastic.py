"""Elastic scaling: re-place a training state on another mesh.

The counterpart of the JAX package's ``distributed/elastic.py``. When the
data axis changes size (a slice lost, or capacity added), the run restarts
on the new mesh from its last checkpoint:

    1. the checkpoint is read whole (``checkpoint.restore``; a sharded run
       writes it whole);
    2. :func:`reshard` places every leaf by its specs on the new mesh
       (``distributed.placement``): values unchanged, bit for bit;
    3. the global batch is split over the new data extent, with gradient
       accumulation where it does not divide (:func:`shrink_batch_plan`);
    4. training resumes, each step the one it would be on a mesh placed
       afresh.

Across cards step 2 is a peer copy of each slice; on one card (shards that
share it) a copy.
"""

from __future__ import annotations

from repro_torch.distributed import placement


def reshard(tree, new_mesh, rules=None, *, zero: bool = True):
    """Every leaf of ``tree`` (placed on any mesh, or whole) placed on the
    placed ``new_mesh`` by its ZeRO specs (``zero``) or its
    tensor-parallel ones under ``rules`` (``default_rules(new_mesh)`` by
    default). Values unchanged."""
    return placement.place_by(tree, new_mesh, rules, zero=zero)


def shrink_batch_plan(global_batch: int, old_data: int, new_data: int):
    """How the per-device batch changes when the data axis resizes.

    Keeps the *global* batch (and thus the optimizer trajectory) constant by
    adjusting gradient accumulation: returns ``(per_device_batch,
    accum_steps)``.
    """
    assert global_batch % old_data == 0
    if global_batch % new_data == 0:
        return global_batch // new_data, 1
    # fall back to accumulation so the global batch stays exact
    accum = 1
    while (global_batch % (new_data * accum) != 0
           or (global_batch // (new_data * accum)) < 1):
        accum += 1
        if accum > global_batch:
            raise ValueError("cannot factor global batch over new mesh")
    return global_batch // (new_data * accum), accum
