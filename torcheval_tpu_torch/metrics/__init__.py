"""Streaming metrics. JAX counterpart: ``torcheval_tpu/metrics/__init__.py``."""

from torcheval_tpu_torch.metrics.classification import (
    BinaryAccuracy,
    BinaryAUPRC,
    BinaryAUROC,
    MulticlassAccuracy,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction

__all__ = [
    "BinaryAccuracy",
    "BinaryAUPRC",
    "BinaryAUROC",
    "Metric",
    "MulticlassAccuracy",
    "Reduction",
]
