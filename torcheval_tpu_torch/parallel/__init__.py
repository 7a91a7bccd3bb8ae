"""Data-parallel evaluation over ``torch.distributed`` ranks. JAX
counterpart: ``torcheval_tpu/parallel/__init__.py``."""

from torcheval_tpu_torch.parallel.bootstrap import init_from_env, is_initialized, shutdown
from torcheval_tpu_torch.parallel.evaluator import ShardedEvaluator
from torcheval_tpu_torch.parallel.mesh import (
    DataParallelMesh,
    MeshAxis,
    block_bounds,
    data_parallel_mesh,
    label_tile,
    mesh_axis,
    shard_batch,
    shard_tile_width,
    tile_bounds,
)

__all__ = [
    "DataParallelMesh",
    "MeshAxis",
    "ShardedEvaluator",
    "block_bounds",
    "data_parallel_mesh",
    "init_from_env",
    "is_initialized",
    "label_tile",
    "mesh_axis",
    "shard_batch",
    "shard_tile_width",
    "shutdown",
    "tile_bounds",
]
