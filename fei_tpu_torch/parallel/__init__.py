"""The serving mesh (counterpart of fei_tpu/parallel/, first half: the mesh,
multi-host init, the sharding tables and the rank-0/follower dispatch).
Sequence, expert and pipeline parallelism are not ported yet."""

from fei_tpu_torch.parallel.distributed import initialize as initialize_distributed
from fei_tpu_torch.parallel.mesh import Mesh, best_mesh_shape, make_mesh, parse_mesh_shape
from fei_tpu_torch.parallel.sharding import (
    cache_shardings,
    param_shardings,
    shard_engine,
    shard_params,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "parse_mesh_shape",
    "best_mesh_shape",
    "param_shardings",
    "cache_shardings",
    "shard_params",
    "shard_engine",
    "initialize_distributed",
]
