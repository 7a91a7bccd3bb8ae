"""Accuracy metric classes.

JAX counterpart: ``torcheval_tpu/metrics/classification/accuracy.py``
(``MulticlassAccuracy``, ``BinaryAccuracy``, ``MultilabelAccuracy`` and
``TopKMultilabelAccuracy``). The JAX classes defer their
folds (``metrics/deferred.py``) to batch XLA dispatches. PyTorch runs
eagerly, so here ``update()`` folds each batch into the counters at once,
with the same results; the deferred folds come with ``MetricCollection``.
Counters are updated in place: the metric owns them, and ``state_dict()``
returns copies.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
    _accuracy_compute,
    _accuracy_param_check,
    _accuracy_update_input_check,
    _binary_accuracy_update,
    _binary_shape_check,
    _multiclass_accuracy_update,
    _multilabel_accuracy_param_check,
    _multilabel_accuracy_update,
    _topk_method_check,
    _topk_multilabel_accuracy_param_check,
    _topk_multilabel_accuracy_update,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.utils.devices import DeviceLike


class MulticlassAccuracy(Metric[torch.Tensor]):
    """Streaming multiclass accuracy. State is an int32 scalar pair (micro)
    or per-class ``(num_classes,)`` int32 counters (macro, none)."""

    def __init__(
        self,
        *,
        average: Optional[str] = "micro",
        num_classes: Optional[int] = None,
        k: int = 1,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _accuracy_param_check(average, num_classes, k)
        self.average = average
        self.num_classes = num_classes
        self.k = k
        shape = () if average == "micro" else (num_classes,)
        self._add_state(
            "num_correct", zeros_state(shape, dtype=torch.int32), reduction=Reduction.SUM
        )
        self._add_state(
            "num_total", zeros_state(shape, dtype=torch.int32), reduction=Reduction.SUM
        )

    def _fold(self, num_correct: torch.Tensor, num_total: torch.Tensor) -> None:
        self.num_correct += num_correct
        self.num_total += num_total

    def update(self, input, target) -> "MulticlassAccuracy":
        input, target = self._input(input), self._input(target)
        _accuracy_update_input_check(input, target, self.num_classes, self.k)
        self._fold(
            *_multiclass_accuracy_update(
                input, target, self.average, self.num_classes, self.k
            )
        )
        return self

    def compute(self) -> torch.Tensor:
        return _accuracy_compute(self.num_correct, self.num_total, self.average)

    def merge_state(self, metrics: Iterable["MulticlassAccuracy"]) -> "MulticlassAccuracy":
        for metric in metrics:
            self.num_correct = self.num_correct + metric.num_correct.to(self._device)
            self.num_total = self.num_total + metric.num_total.to(self._device)
        return self


class BinaryAccuracy(MulticlassAccuracy):
    """Streaming binary accuracy with thresholding."""

    def __init__(self, *, threshold: float = 0.5, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self.threshold = threshold

    def update(self, input, target) -> "BinaryAccuracy":
        input, target = self._input(input), self._input(target)
        _binary_shape_check(input, target)
        self._fold(*_binary_accuracy_update(input, target, self.threshold))
        return self


class MultilabelAccuracy(MulticlassAccuracy):
    """Streaming multilabel accuracy under a configurable criterion
    (exact_match, hamming, overlap, contain, belong)."""

    def __init__(
        self,
        *,
        threshold: float = 0.5,
        criteria: str = "exact_match",
        device: DeviceLike = None,
    ) -> None:
        _multilabel_accuracy_param_check(criteria)
        super().__init__(device=device)
        self.threshold = threshold
        self.criteria = criteria

    def update(self, input, target) -> "MultilabelAccuracy":
        input, target = self._input(input), self._input(target)
        self._fold(*_multilabel_accuracy_update(input, target, self.threshold, self.criteria))
        return self


class TopKMultilabelAccuracy(MulticlassAccuracy):
    """Streaming multilabel accuracy where the prediction set is the top-k
    scores of each row. The top-k indices come from ``ops/topk.py``: on a
    CUDA tensor with more than 1024 labels and ``k <= 128``, the top-k
    kernel. ``topk_method`` forces one lowering and is checked here, at
    construction."""

    def __init__(
        self,
        *,
        criteria: str = "exact_match",
        k: int = 2,
        topk_method: str = "auto",
        device: DeviceLike = None,
    ) -> None:
        _topk_multilabel_accuracy_param_check(criteria, k)
        _topk_method_check(topk_method)
        super().__init__(device=device)
        self.criteria = criteria
        self.k = k
        self.topk_method = topk_method

    def update(self, input, target) -> "TopKMultilabelAccuracy":
        input, target = self._input(input), self._input(target)
        self._fold(
            *_topk_multilabel_accuracy_update(
                input, target, self.criteria, self.k, self.topk_method
            )
        )
        return self
