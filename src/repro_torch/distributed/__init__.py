"""The JAX package's ``distributed`` package: tensor-parallel serving and
the training specs (``sharding``), the training state placed by them
(``placement``) and resharding between meshes (``elastic``)."""

from repro_torch.distributed.sharding import (ServeMesh, Shards,
                                              serve_mesh,
                                              serve_tp_unsupported,
                                              shard_caches_for_serve,
                                              shard_params_for_serve)

__all__ = ["ServeMesh", "Shards", "serve_mesh", "serve_tp_unsupported",
           "shard_caches_for_serve", "shard_params_for_serve"]
