"""Functional classification metrics. JAX counterpart:
``torcheval_tpu/metrics/functional/classification/__init__.py``."""

from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
    binary_accuracy,
    multiclass_accuracy,
    multilabel_accuracy,
    topk_multilabel_accuracy,
)
from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    binary_auprc,
    binary_auroc,
)
from torcheval_tpu_torch.metrics.functional.classification.f1_score import (
    binary_f1_score,
    multiclass_f1_score,
)

__all__ = [
    "binary_accuracy",
    "binary_auprc",
    "binary_auroc",
    "binary_f1_score",
    "multiclass_accuracy",
    "multiclass_f1_score",
    "multilabel_accuracy",
    "topk_multilabel_accuracy",
]
