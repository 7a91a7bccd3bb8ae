"""Functional ranking and retrieval metrics. JAX counterpart:
``torcheval_tpu/metrics/functional/ranking/__init__.py``."""

from torcheval_tpu_torch.metrics.functional.ranking.frequency import frequency_at_k
from torcheval_tpu_torch.metrics.functional.ranking.hit_rate import hit_rate
from torcheval_tpu_torch.metrics.functional.ranking.num_collisions import num_collisions
from torcheval_tpu_torch.metrics.functional.ranking.reciprocal_rank import reciprocal_rank
from torcheval_tpu_torch.metrics.functional.ranking.retrieval import (
    map_at_k,
    ndcg_at_k,
    recall_at_k,
    retrieval_hit_rate,
)

__all__ = [
    "frequency_at_k",
    "hit_rate",
    "map_at_k",
    "ndcg_at_k",
    "num_collisions",
    "recall_at_k",
    "reciprocal_rank",
    "retrieval_hit_rate",
]
