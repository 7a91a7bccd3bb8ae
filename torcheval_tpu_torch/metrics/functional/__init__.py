"""Functional metrics. JAX counterpart:
``torcheval_tpu/metrics/functional/__init__.py``."""

from torcheval_tpu_torch.metrics.functional.aggregation import mean, sum  # noqa: A004
from torcheval_tpu_torch.metrics.functional.classification import (
    binary_accuracy,
    binary_auprc,
    binary_auroc,
    multiclass_accuracy,
    multilabel_accuracy,
    topk_multilabel_accuracy,
)
from torcheval_tpu_torch.metrics.functional.ranking import (
    frequency_at_k,
    hit_rate,
    map_at_k,
    ndcg_at_k,
    num_collisions,
    recall_at_k,
    reciprocal_rank,
    retrieval_hit_rate,
)
from torcheval_tpu_torch.metrics.functional.regression import mean_squared_error

__all__ = [
    "binary_accuracy",
    "binary_auprc",
    "binary_auroc",
    "frequency_at_k",
    "hit_rate",
    "map_at_k",
    "mean",
    "mean_squared_error",
    "multiclass_accuracy",
    "multilabel_accuracy",
    "ndcg_at_k",
    "num_collisions",
    "recall_at_k",
    "reciprocal_rank",
    "retrieval_hit_rate",
    "sum",
    "topk_multilabel_accuracy",
]
