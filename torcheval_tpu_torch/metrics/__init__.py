"""Streaming metrics. JAX counterpart: ``torcheval_tpu/metrics/__init__.py``."""

from torcheval_tpu_torch.metrics.aggregation import Cat, Max, Mean, Min, Quantile, Sum
from torcheval_tpu_torch.metrics.classification import (
    BinaryAccuracy,
    BinaryAUPRC,
    BinaryAUROC,
    BinaryBinnedPrecisionRecallCurve,
    BinaryConfusionMatrix,
    BinaryF1Score,
    BinaryPrecision,
    BinaryPrecisionRecallCurve,
    BinaryRecall,
    MulticlassAccuracy,
    MulticlassAUPRC,
    MulticlassAUROC,
    MulticlassBinnedPrecisionRecallCurve,
    MulticlassConfusionMatrix,
    MulticlassF1Score,
    MulticlassPrecision,
    MulticlassPrecisionRecallCurve,
    MulticlassRecall,
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
from torcheval_tpu_torch.metrics.sliced import SlicedMetricCollection, SlicedResult, SliceTable
from torcheval_tpu_torch.metrics.state import Reduction

__all__ = [
    "BinaryAccuracy",
    "BinaryAUPRC",
    "BinaryAUROC",
    "BinaryBinnedPrecisionRecallCurve",
    "BinaryConfusionMatrix",
    "BinaryF1Score",
    "BinaryPrecision",
    "BinaryPrecisionRecallCurve",
    "BinaryRecall",
    "Cat",
    "HitRate",
    "MAP",
    "Max",
    "Mean",
    "MeanSquaredError",
    "Metric",
    "MetricCollection",
    "Min",
    "MulticlassAccuracy",
    "MulticlassAUPRC",
    "MulticlassAUROC",
    "MulticlassBinnedPrecisionRecallCurve",
    "MulticlassConfusionMatrix",
    "MulticlassF1Score",
    "MulticlassPrecision",
    "MulticlassPrecisionRecallCurve",
    "MulticlassRecall",
    "MultilabelAccuracy",
    "NDCG",
    "Quantile",
    "RecallAtK",
    "ReciprocalRank",
    "Reduction",
    "SlicedMetricCollection",
    "SlicedResult",
    "SliceTable",
    "Sum",
    "TopKMultilabelAccuracy",
]
