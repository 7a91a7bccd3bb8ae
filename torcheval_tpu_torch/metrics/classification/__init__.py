"""Classification metric classes. JAX counterpart:
``torcheval_tpu/metrics/classification/__init__.py``."""

from torcheval_tpu_torch.metrics.classification.accuracy import (
    BinaryAccuracy,
    MulticlassAccuracy,
)
from torcheval_tpu_torch.metrics.classification.auroc import BinaryAUPRC, BinaryAUROC

__all__ = ["BinaryAccuracy", "BinaryAUPRC", "BinaryAUROC", "MulticlassAccuracy"]
