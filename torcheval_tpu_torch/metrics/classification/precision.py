"""Precision metric classes.

JAX counterpart: ``torcheval_tpu/metrics/classification/precision.py``
(``MulticlassPrecision``, ``BinaryPrecision``). ``update()`` defers the
batch; the concat fold counts the pending batches in one
``match_triple_counts`` (two histogram launches on the card). State is the
int32 triple ``num_tp``, ``num_fp``, ``num_label``: scalars for
``average="micro"`` and the binary metric, ``(num_classes,)`` otherwise,
all reduced by SUM.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.functional.classification.precision import (
    _binary_input_check,
    _binary_precision_update,
    _precision_compute,
    _precision_input_check,
    _precision_param_check,
    _precision_update,
    _warn_nan_classes,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.utils.devices import DeviceLike

_STATES = ("num_tp", "num_fp", "num_label")


def _prec_fold(input, target, num_classes, average):
    return dict(zip(_STATES, _precision_update(input, target, num_classes, average)))


def _binprec_fold(input, target, threshold):
    return dict(zip(_STATES, _binary_precision_update(input, target, threshold)))


class MulticlassPrecision(DeferredFoldMixin, Metric[torch.Tensor]):
    """Streaming multiclass precision (``average`` in micro, macro,
    weighted or None for per-class values)."""

    _fold_fn = staticmethod(_prec_fold)
    _compute_fn = staticmethod(_precision_compute)

    def __init__(
        self,
        *,
        num_classes: Optional[int] = None,
        average: Optional[str] = "micro",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _precision_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average
        shape = () if average == "micro" else (num_classes,)
        for name in _STATES:
            self._add_state(name, zeros_state(shape, dtype=torch.int32), reduction=Reduction.SUM)
        self._init_deferred()
        self._fold_params = (num_classes, average)
        self._compute_params = (average,)

    def _update_check(self, input, target) -> None:
        _precision_input_check(input, target, self.num_classes)

    def update(self, input, target) -> "MulticlassPrecision":
        self._defer(self._input(input), self._input(target))
        return self

    def _on_window_result(self, result):
        if self.average in (None, "None"):
            _warn_nan_classes(self.num_tp, self.num_fp, "Precision")
        return result

    def compute(self) -> torch.Tensor:
        return self._deferred_compute()

    def merge_state(self, metrics: Iterable["MulticlassPrecision"]) -> "MulticlassPrecision":
        for metric in self._fold_for_merge(metrics):
            for name in _STATES:
                setattr(self, name, getattr(self, name) + getattr(metric, name).to(self._device))
        return self


class BinaryPrecision(MulticlassPrecision):
    """Streaming binary precision after thresholding the scores at
    ``threshold``."""

    _fold_fn = staticmethod(_binprec_fold)

    def __init__(self, *, threshold: float = 0.5, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self.threshold = threshold
        self._fold_params = (threshold,)

    def _update_check(self, input, target) -> None:
        _binary_input_check(input, target)
