"""Confusion-matrix metric classes.

JAX counterpart: ``torcheval_tpu/metrics/classification/confusion_matrix.py``
(``MulticlassConfusionMatrix``, ``BinaryConfusionMatrix``). ``update()``
defers the batch; the concat fold (``_fold_per_chunk`` False) counts the
pending batches in one ``confusion_matrix_counts``, one histogram launch
over ``C * C`` bins on the card. State is the int32 ``(C, C)`` matrix,
reduced by SUM; the compute is the normalisation.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    _binary_prediction,
    _confusion_matrix_input_check,
    _confusion_matrix_param_check,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.ops.confusion import confusion_matrix_counts, normalize_confusion_matrix
from torcheval_tpu_torch.utils.devices import DeviceLike


def _cm_fold(input, target, num_classes):
    if input.ndim == 2:
        input = torch.argmax(input, dim=1)
    return {"confusion_matrix": confusion_matrix_counts(input, target, num_classes)}


def _bincm_fold(input, target, threshold):
    return {"confusion_matrix": confusion_matrix_counts(_binary_prediction(input, threshold), target, 2)}


class MulticlassConfusionMatrix(DeferredFoldMixin, Metric[torch.Tensor]):
    """Streaming ``(num_classes, num_classes)`` confusion counts; rows are
    true classes. ``normalize`` as in ``ops/confusion.py``."""

    _fold_fn = staticmethod(_cm_fold)
    _compute_fn = staticmethod(normalize_confusion_matrix)

    def __init__(
        self,
        num_classes: int,
        *,
        normalize: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _confusion_matrix_param_check(num_classes, normalize)
        self.num_classes = num_classes
        self.normalize = normalize
        self._add_state(
            "confusion_matrix",
            zeros_state((num_classes, num_classes), dtype=torch.int32),
            reduction=Reduction.SUM,
        )
        self._init_deferred()
        self._fold_params = (num_classes,)
        self._compute_params = (normalize,)

    def _update_check(self, input, target) -> None:
        _confusion_matrix_input_check(input, target, self.num_classes)

    def update(self, input, target) -> "MulticlassConfusionMatrix":
        self._defer(self._input(input), self._input(target))
        return self

    def compute(self) -> torch.Tensor:
        return self._deferred_compute()

    def merge_state(self, metrics: Iterable["MulticlassConfusionMatrix"]) -> "MulticlassConfusionMatrix":
        for metric in self._fold_for_merge(metrics):
            self.confusion_matrix = self.confusion_matrix + metric.confusion_matrix.to(self._device)
        return self


class BinaryConfusionMatrix(MulticlassConfusionMatrix):
    """Streaming 2x2 confusion counts after thresholding the scores at
    ``threshold``."""

    _fold_fn = staticmethod(_bincm_fold)

    def __init__(
        self,
        *,
        threshold: float = 0.5,
        normalize: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(2, normalize=normalize, device=device)
        self.threshold = threshold
        self._fold_params = (threshold,)

    def _update_check(self, input, target) -> None:
        _confusion_matrix_input_check(input, target)
