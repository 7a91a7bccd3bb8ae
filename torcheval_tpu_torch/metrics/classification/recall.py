"""Recall metric classes.

JAX counterpart: ``torcheval_tpu/metrics/classification/recall.py``
(``MulticlassRecall``, ``BinaryRecall``). ``update()`` defers the batch; the
concat fold counts the pending batches in one ``match_triple_counts`` (two
histogram launches on the card). State is the int32 triple ``num_tp``,
``num_labels``, ``num_predictions`` (scalars for ``average="micro"``,
``(num_classes,)`` otherwise), or the binary pair ``num_tp``,
``num_true_labels``, all reduced by SUM. The warnings for classes with no
label read the folded counts on the host after the compute, as F1's do.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.functional.classification.precision import (
    _binary_input_check,
)
from torcheval_tpu_torch.metrics.functional.classification.recall import (
    _binary_recall_compute,
    _binary_recall_update,
    _recall_compute,
    _recall_input_check,
    _recall_param_check,
    _recall_update,
    _warn_nan_recall,
    _warn_no_positive,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.utils.devices import DeviceLike

_STATES = ("num_tp", "num_labels", "num_predictions")
_BINARY_STATES = ("num_tp", "num_true_labels")


def _rec_fold(input, target, num_classes, average):
    return dict(zip(_STATES, _recall_update(input, target, num_classes, average)))


def _binrec_fold(input, target, threshold):
    return dict(zip(_BINARY_STATES, _binary_recall_update(input, target, threshold)))


class _RecallBase(DeferredFoldMixin, Metric[torch.Tensor]):
    _state_names = _STATES

    def update(self, input, target):
        self._defer(self._input(input), self._input(target))
        return self

    def compute(self) -> torch.Tensor:
        return self._deferred_compute()

    def merge_state(self, metrics: Iterable["_RecallBase"]):
        for metric in self._fold_for_merge(metrics):
            for name in self._state_names:
                setattr(self, name, getattr(self, name) + getattr(metric, name).to(self._device))
        return self


class MulticlassRecall(_RecallBase):
    """Streaming multiclass recall (``average`` in micro, macro, weighted or
    None for per-class values)."""

    _fold_fn = staticmethod(_rec_fold)
    _compute_fn = staticmethod(_recall_compute)

    def __init__(
        self,
        *,
        num_classes: Optional[int] = None,
        average: Optional[str] = "micro",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _recall_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average
        shape = () if average == "micro" else (num_classes,)
        for name in _STATES:
            self._add_state(name, zeros_state(shape, dtype=torch.int32), reduction=Reduction.SUM)
        self._init_deferred()
        self._fold_params = (num_classes, average)
        self._compute_params = (average,)

    def _update_check(self, input, target) -> None:
        _recall_input_check(input, target, self.num_classes)

    def _on_window_result(self, result):
        if self.average != "micro":
            _warn_nan_recall(self.num_labels)
        return result


class BinaryRecall(_RecallBase):
    """Streaming binary recall after thresholding the scores at
    ``threshold``."""

    _state_names = _BINARY_STATES
    _fold_fn = staticmethod(_binrec_fold)
    _compute_fn = staticmethod(_binary_recall_compute)

    def __init__(self, *, threshold: float = 0.5, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self.threshold = threshold
        for name in _BINARY_STATES:
            self._add_state(name, zeros_state((), dtype=torch.int32), reduction=Reduction.SUM)
        self._init_deferred()
        self._fold_params = (threshold,)

    def _update_check(self, input, target) -> None:
        _binary_input_check(input, target)

    def _on_window_result(self, result):
        _warn_no_positive(self.num_true_labels)
        return result
