"""Functional metrics. JAX counterpart:
``torcheval_tpu/metrics/functional/__init__.py``."""

from torcheval_tpu_torch.metrics.functional.classification import (
    binary_accuracy,
    binary_auprc,
    binary_auroc,
    multiclass_accuracy,
)

__all__ = ["binary_accuracy", "binary_auprc", "binary_auroc", "multiclass_accuracy"]
