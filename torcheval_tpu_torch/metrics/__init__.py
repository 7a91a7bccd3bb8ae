"""Streaming metrics. JAX counterpart: ``torcheval_tpu/metrics/__init__.py``."""

from torcheval_tpu_torch.metrics.aggregation import Max, Mean, Min, Sum
from torcheval_tpu_torch.metrics.classification import (
    BinaryAccuracy,
    BinaryAUPRC,
    BinaryAUROC,
    MulticlassAccuracy,
    MultilabelAccuracy,
    TopKMultilabelAccuracy,
)
from torcheval_tpu_torch.metrics.collection import MetricCollection
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.ranking import (
    MAP,
    NDCG,
    HitRate,
    RecallAtK,
    ReciprocalRank,
)
from torcheval_tpu_torch.metrics.regression import MeanSquaredError
from torcheval_tpu_torch.metrics.sliced import SlicedMetricCollection
from torcheval_tpu_torch.metrics.state import Reduction

__all__ = [
    "BinaryAccuracy",
    "BinaryAUPRC",
    "BinaryAUROC",
    "HitRate",
    "MAP",
    "Max",
    "Mean",
    "MeanSquaredError",
    "Metric",
    "MetricCollection",
    "Min",
    "MulticlassAccuracy",
    "MultilabelAccuracy",
    "NDCG",
    "RecallAtK",
    "ReciprocalRank",
    "Reduction",
    "SlicedMetricCollection",
    "Sum",
    "TopKMultilabelAccuracy",
]
