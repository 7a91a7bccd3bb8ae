"""Accuracy metric classes.

JAX counterpart: ``torcheval_tpu/metrics/classification/accuracy.py``
(``MulticlassAccuracy``, ``BinaryAccuracy``, ``MultilabelAccuracy`` and
``TopKMultilabelAccuracy``). Each class declares its fold and its compute as
module-level pure functions with their statics, the contract of
``metrics/deferred.py``: ``update()`` validates the batch and defers it, and
the stacked fold (``_fold_per_chunk``) folds the pending batches at the
next read or valve, as in the JAX package. Every delta is an int32 count
(``_fold_exact``), so a ragged window folds its concatenated rows in one
call. The sliced collection (``metrics/sliced.py``) runs the same folds per
sample.
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
    _multilabel_shape_check,
    _topk_method_check,
    _topk_multilabel_accuracy_param_check,
    _topk_multilabel_accuracy_update,
)
from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.utils.devices import DeviceLike


def _acc_fold(input, target, average, num_classes, k):
    num_correct, num_total = _multiclass_accuracy_update(input, target, average, num_classes, k)
    return {"num_correct": num_correct, "num_total": num_total}


def _binacc_fold(input, target, threshold):
    num_correct, num_total = _binary_accuracy_update(input, target, threshold)
    return {"num_correct": num_correct, "num_total": num_total}


def _mlacc_fold(input, target, threshold, criteria):
    num_correct, num_total = _multilabel_accuracy_update(input, target, threshold, criteria)
    return {"num_correct": num_correct, "num_total": num_total}


def _topk_fold(input, target, criteria, k, topk_method):
    num_correct, num_total = _topk_multilabel_accuracy_update(
        input, target, criteria, k, topk_method
    )
    return {"num_correct": num_correct, "num_total": num_total}


class MulticlassAccuracy(DeferredFoldMixin, Metric[torch.Tensor]):
    """Streaming multiclass accuracy. State is an int32 scalar pair (micro)
    or per-class ``(num_classes,)`` int32 counters (macro, none)."""

    _fold_fn = staticmethod(_acc_fold)
    _fold_per_chunk = True
    _fold_exact = True  # int32 counts, here and in every subclass
    _compute_fn = staticmethod(_accuracy_compute)

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
        self._init_deferred()
        self._fold_params = (average, num_classes, k)
        self._compute_params = (average,)

    def _update_check(self, input, target) -> None:
        _accuracy_update_input_check(input, target, self.num_classes, self.k)

    def update(self, input, target) -> "MulticlassAccuracy":
        self._defer(self._input(input), self._input(target))
        return self

    def compute(self) -> torch.Tensor:
        return self._deferred_compute()

    def merge_state(self, metrics: Iterable["MulticlassAccuracy"]) -> "MulticlassAccuracy":
        metrics = self._fold_for_merge(metrics)
        for metric in metrics:
            self.num_correct = self.num_correct + metric.num_correct.to(self._device)
            self.num_total = self.num_total + metric.num_total.to(self._device)
        return self


class BinaryAccuracy(MulticlassAccuracy):
    """Streaming binary accuracy with thresholding."""

    _fold_fn = staticmethod(_binacc_fold)

    def __init__(self, *, threshold: float = 0.5, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self.threshold = threshold
        self._fold_params = (threshold,)

    def _update_check(self, input, target) -> None:
        _binary_shape_check(input, target)


class MultilabelAccuracy(MulticlassAccuracy):
    """Streaming multilabel accuracy under a configurable criterion
    (exact_match, hamming, overlap, contain, belong)."""

    _fold_fn = staticmethod(_mlacc_fold)

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
        self._fold_params = (threshold, criteria)

    def _update_check(self, input, target) -> None:
        _multilabel_shape_check(input, target)


class TopKMultilabelAccuracy(MulticlassAccuracy):
    """Streaming multilabel accuracy where the prediction set is the top-k
    scores of each row. The top-k indices come from ``ops/topk.py``: on a
    CUDA tensor with more than 1024 labels and ``k <= 128``, the top-k
    kernel. ``topk_method`` forces one lowering and is checked here, at
    construction. Not sliceable: the top-k kernel's wrapper has no
    ``torch.func.vmap`` rule (``_fold_vmap = False``, as in the JAX
    package), so the batches of a window fold one by one."""

    _fold_fn = staticmethod(_topk_fold)
    _fold_vmap = False

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
        self._fold_params = (criteria, k, topk_method)

    def _update_check(self, input, target) -> None:
        _multilabel_shape_check(input, target)
        if input.ndim != 2:
            raise ValueError(
                "input should have shape (num_sample, num_classes) for k > 1, "
                f"got shape {tuple(input.shape)}."
            )
