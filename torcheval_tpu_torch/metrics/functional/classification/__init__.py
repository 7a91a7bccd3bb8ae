"""Functional classification metrics. JAX counterpart:
``torcheval_tpu/metrics/functional/classification/__init__.py``."""

from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
    binary_accuracy,
    multiclass_accuracy,
)
from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    binary_auprc,
    binary_auroc,
)

__all__ = ["binary_accuracy", "binary_auprc", "binary_auroc", "multiclass_accuracy"]
