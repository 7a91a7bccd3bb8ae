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
    multiclass_auprc,
    multiclass_auroc,
)
from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
    binary_binned_precision_recall_curve,
    multiclass_binned_precision_recall_curve,
)
from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
)
from torcheval_tpu_torch.metrics.functional.classification.f1_score import (
    binary_f1_score,
    multiclass_f1_score,
)
from torcheval_tpu_torch.metrics.functional.classification.precision import (
    binary_precision,
    multiclass_precision,
)
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
)
from torcheval_tpu_torch.metrics.functional.classification.recall import (
    binary_recall,
    multiclass_recall,
)

__all__ = [
    "binary_accuracy",
    "binary_auprc",
    "binary_auroc",
    "binary_binned_precision_recall_curve",
    "binary_confusion_matrix",
    "binary_f1_score",
    "binary_precision",
    "binary_precision_recall_curve",
    "binary_recall",
    "multiclass_accuracy",
    "multiclass_auprc",
    "multiclass_auroc",
    "multiclass_binned_precision_recall_curve",
    "multiclass_confusion_matrix",
    "multiclass_f1_score",
    "multiclass_precision",
    "multiclass_precision_recall_curve",
    "multiclass_recall",
    "multilabel_accuracy",
    "topk_multilabel_accuracy",
]
