"""Classification metric classes. JAX counterpart:
``torcheval_tpu/metrics/classification/__init__.py``."""

from torcheval_tpu_torch.metrics.classification.accuracy import (
    BinaryAccuracy,
    MulticlassAccuracy,
    MultilabelAccuracy,
    TopKMultilabelAccuracy,
)
from torcheval_tpu_torch.metrics.classification.auroc import BinaryAUPRC, BinaryAUROC
from torcheval_tpu_torch.metrics.classification.f1_score import BinaryF1Score, MulticlassF1Score

__all__ = [
    "BinaryAccuracy",
    "BinaryAUPRC",
    "BinaryAUROC",
    "BinaryF1Score",
    "MulticlassAccuracy",
    "MulticlassF1Score",
    "MultilabelAccuracy",
    "TopKMultilabelAccuracy",
]
