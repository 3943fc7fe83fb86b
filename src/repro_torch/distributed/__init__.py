"""Tensor-parallel serving (``sharding``): the serving half of the JAX
package's ``distributed`` package."""

from repro_torch.distributed.sharding import (ServeMesh, Shards,
                                              serve_mesh,
                                              serve_tp_unsupported,
                                              shard_caches_for_serve,
                                              shard_params_for_serve)

__all__ = ["ServeMesh", "Shards", "serve_mesh", "serve_tp_unsupported",
           "shard_caches_for_serve", "shard_params_for_serve"]
