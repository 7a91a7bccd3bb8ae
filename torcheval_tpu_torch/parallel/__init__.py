"""Data-parallel evaluation over ``torch.distributed`` ranks. JAX
counterpart: ``torcheval_tpu/parallel/__init__.py``."""

from torcheval_tpu_torch.parallel.bootstrap import init_from_env, is_initialized, shutdown
from torcheval_tpu_torch.parallel.evaluator import ShardedEvaluator
from torcheval_tpu_torch.parallel.mesh import (
    DataParallelMesh,
    block_bounds,
    data_parallel_mesh,
    shard_batch,
)

__all__ = [
    "DataParallelMesh",
    "ShardedEvaluator",
    "block_bounds",
    "data_parallel_mesh",
    "init_from_env",
    "is_initialized",
    "shard_batch",
    "shutdown",
]
