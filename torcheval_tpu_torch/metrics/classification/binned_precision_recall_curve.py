"""Binned precision-recall curve metric classes.

JAX counterpart:
``torcheval_tpu/metrics/classification/binned_precision_recall_curve.py``
(``BinaryBinnedPrecisionRecallCurve``,
``MulticlassBinnedPrecisionRecallCurve``). State is int32 counters of shape
``(T,)`` or ``(T, C)``, merged by a sum, beside the thresholds, which the
reference registers as state (reduced by MAX: every replica holds the same
ones). ``update()`` defers the batch. These are per-chunk folds
(``_fold_per_chunk``): a window stacks its batches and runs the bucket
count of ``functional/.../binned_precision_recall_curve.py`` under
``torch.func.vmap``, where the unweighted count becomes one segment sum over
``B * bins`` segments on the card. The fold reads the thresholds from a CPU
copy held in its parameters (the JAX package rebuilds them as a constant of
the compiled fold) and copies them to the batch's device without a
synchronisation.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
    ThresholdSpec,
    _binary_binned_compute,
    _binary_binned_update,
    _binned_precision_recall_curve_param_check,
    _create_threshold_tensor,
    _multiclass_binned_compute,
    _multiclass_binned_update,
)
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_update_input_check,
    _multiclass_precision_recall_curve_update_input_check,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.utils.devices import DeviceLike

_COUNTER_NAMES = ("num_tp", "num_fp", "num_fn")


def _binary_binned_fold(input, target, thresholds):
    return dict(zip(_COUNTER_NAMES, _binary_binned_update(input, target, thresholds)))


def _binary_binned_deferred_compute(threshold, num_tp, num_fp, num_fn):
    """The terminal compute, states in registration order (the thresholds
    first; they pass through as the third output)."""
    precision, recall = _binary_binned_compute(num_tp, num_fp, num_fn)
    return precision, recall, threshold


def _multiclass_binned_fold(input, target, thresholds, num_classes):
    return dict(
        zip(_COUNTER_NAMES, _multiclass_binned_update(input, target, thresholds, num_classes))
    )


class _BinnedCurveBase(DeferredFoldMixin, Metric):
    _fold_per_chunk = True

    def _init_binned(self, threshold: ThresholdSpec, shape: Tuple[int, ...]) -> torch.Tensor:
        threshold = _create_threshold_tensor(threshold).cpu()
        _binned_precision_recall_curve_param_check(threshold)
        self._add_state("threshold", threshold, reduction=Reduction.MAX)
        n = threshold.shape[0]
        for name in _COUNTER_NAMES:
            self._add_state(name, zeros_state((n, *shape), dtype=torch.int32), reduction=Reduction.SUM)
        self._init_deferred()
        return threshold

    def update(self, input, target):
        self._defer(self._input(input), self._input(target))
        return self

    def merge_state(self, metrics: Iterable["_BinnedCurveBase"]):
        for metric in self._fold_for_merge(metrics):
            for name in _COUNTER_NAMES:
                setattr(self, name, getattr(self, name) + getattr(metric, name).to(self._device))
        return self


class BinaryBinnedPrecisionRecallCurve(_BinnedCurveBase):
    """Streaming binary precision-recall curve at fixed thresholds:
    ``threshold`` is a count (even steps over [0, 1]), a list or a tensor of
    sorted thresholds in [0, 1]. ``compute()`` gives ``(precision, recall,
    thresholds)``."""

    _fold_fn = staticmethod(_binary_binned_fold)
    _compute_fn = staticmethod(_binary_binned_deferred_compute)

    def __init__(self, *, threshold: ThresholdSpec = 100, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._fold_params = (self._init_binned(threshold, ()),)

    def _update_check(self, input, target) -> None:
        _binary_precision_recall_curve_update_input_check(input, target)

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self._deferred_compute()


class MulticlassBinnedPrecisionRecallCurve(_BinnedCurveBase):
    """Streaming one-vs-all precision-recall curves at fixed thresholds;
    ``compute()`` gives ``(precision, recall, thresholds)`` with one
    ``(T+1,)`` curve per class in each list."""

    _fold_fn = staticmethod(_multiclass_binned_fold)

    def __init__(
        self,
        num_classes: int,
        *,
        threshold: ThresholdSpec = 100,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        if num_classes is None or num_classes < 2:
            raise ValueError(f"num_classes must be at least 2, got {num_classes}.")
        self.num_classes = num_classes
        self._fold_params = (self._init_binned(threshold, (num_classes,)), num_classes)

    def _update_check(self, input, target) -> None:
        _multiclass_precision_recall_curve_update_input_check(input, target, self.num_classes)

    def compute(self) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
        self._fold_now()
        precision, recall = _multiclass_binned_compute(self.num_tp, self.num_fp, self.num_fn)
        return list(precision.T), list(recall.T), self.threshold
