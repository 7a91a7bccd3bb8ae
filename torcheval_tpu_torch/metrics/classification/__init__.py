"""Classification metric classes. JAX counterpart:
``torcheval_tpu/metrics/classification/__init__.py``."""

from torcheval_tpu_torch.metrics.classification.accuracy import (
    BinaryAccuracy,
    MulticlassAccuracy,
    MultilabelAccuracy,
    TopKMultilabelAccuracy,
)
from torcheval_tpu_torch.metrics.classification.auroc import (
    BinaryAUPRC,
    BinaryAUROC,
    MulticlassAUPRC,
    MulticlassAUROC,
)
from torcheval_tpu_torch.metrics.classification.binary_normalized_entropy import (
    BinaryNormalizedEntropy,
)
from torcheval_tpu_torch.metrics.classification.binned_precision_recall_curve import (
    BinaryBinnedPrecisionRecallCurve,
    MulticlassBinnedPrecisionRecallCurve,
)
from torcheval_tpu_torch.metrics.classification.click_through_rate import (
    ClickThroughRate,
    WindowedClickThroughRate,
)
from torcheval_tpu_torch.metrics.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    MulticlassConfusionMatrix,
)
from torcheval_tpu_torch.metrics.classification.f1_score import BinaryF1Score, MulticlassF1Score
from torcheval_tpu_torch.metrics.classification.precision import (
    BinaryPrecision,
    MulticlassPrecision,
)
from torcheval_tpu_torch.metrics.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
)
from torcheval_tpu_torch.metrics.classification.recall import BinaryRecall, MulticlassRecall
from torcheval_tpu_torch.metrics.classification.weighted_calibration import (
    WeightedCalibration,
    WindowedWeightedCalibration,
)

__all__ = [
    "BinaryAccuracy",
    "BinaryAUPRC",
    "BinaryAUROC",
    "BinaryBinnedPrecisionRecallCurve",
    "BinaryConfusionMatrix",
    "BinaryF1Score",
    "BinaryNormalizedEntropy",
    "BinaryPrecision",
    "BinaryPrecisionRecallCurve",
    "BinaryRecall",
    "ClickThroughRate",
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
    "TopKMultilabelAccuracy",
    "WeightedCalibration",
    "WindowedClickThroughRate",
    "WindowedWeightedCalibration",
]
