"""WeightedCalibration and its windowed variant.

JAX counterpart: ``torcheval_tpu/metrics/classification/weighted_calibration.py``.
The state layout of :mod:`.click_through_rate`, two sums per task, and the
same split: the plain class is deferred (``metrics/deferred.py``), the
windowed variant folds each update eagerly, since its window (the shared
:mod:`._windowed` mixin) keeps every update as its own row.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from torcheval_tpu_torch.metrics.classification._windowed import WindowedStateMixin
from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.functional.classification._task_shapes import (
    check_num_tasks as _check_num_tasks,
)
from torcheval_tpu_torch.metrics.functional.classification.click_through_rate import Weights
from torcheval_tpu_torch.metrics.functional.classification.weighted_calibration import (
    _calibration_compute,
    _calibration_fold,
    _calibration_input_check,
    _weighted_calibration_update,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.utils.devices import DeviceLike


def _fold_calibration(metric, input, target, weight):
    """Place the inputs, fold and reshape to ``(num_tasks,)``: the windowed
    class's eager update (as ``_fold_ctr``)."""
    input, target = metric._input(input), metric._input(target)
    if weight is not None and hasattr(weight, "shape"):
        weight = metric._input(weight)
    pred, label = _weighted_calibration_update(input, target, metric.num_tasks, weight)
    return pred.reshape(metric.num_tasks), label.reshape(metric.num_tasks)


# A weighted update defers its weight as a third column, so the trailing
# parameters are read by arity: rest is (num_tasks,) or (weight, num_tasks).
def _calibration_deferred_fold(input, target, *rest):
    num_tasks = rest[-1]
    weight = rest[0] if len(rest) == 2 else 1.0
    pred, label = _calibration_fold(input, target, weight)
    return {
        "weighted_input_sum": pred.reshape(num_tasks),
        "weighted_label_sum": label.reshape(num_tasks),
    }


class WeightedCalibration(DeferredFoldMixin, Metric[torch.Tensor]):
    """Streaming ``sum(w * input) / sum(w * target)`` per task."""

    _fold_fn = staticmethod(_calibration_deferred_fold)
    _fold_per_chunk = True
    _compute_fn = staticmethod(_calibration_compute)

    def __init__(self, *, num_tasks: int = 1, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        _check_num_tasks(num_tasks)
        self.num_tasks = num_tasks
        for name in ("weighted_input_sum", "weighted_label_sum"):
            self._add_state(name, zeros_state((num_tasks,)), reduction=Reduction.SUM)
        self._init_deferred()
        self._fold_params = (num_tasks,)

    def update(self, input, target, weight: Weights = None) -> "WeightedCalibration":
        input, target = self._input(input), self._input(target)
        if weight is None:
            _calibration_input_check(input, target, self.num_tasks, None)
            self._defer(input, target)
            return self
        weight = self._input(weight)
        _calibration_input_check(input, target, self.num_tasks, weight if weight.ndim else None)
        self._defer(input, target, weight)
        return self

    def compute(self) -> torch.Tensor:
        return self._deferred_compute()

    def merge_state(self, metrics: Iterable["WeightedCalibration"]) -> "WeightedCalibration":
        for metric in self._fold_for_merge(metrics):
            self.weighted_input_sum = self.weighted_input_sum + metric.weighted_input_sum.to(
                self._device
            )
            self.weighted_label_sum = self.weighted_label_sum + metric.weighted_label_sum.to(
                self._device
            )
        return self


class WindowedWeightedCalibration(
    WindowedStateMixin, Metric[Tuple[torch.Tensor, torch.Tensor]]
):
    """Calibration over the last ``window_size`` updates, with the window,
    merge and compute of
    :class:`~torcheval_tpu_torch.metrics.WindowedClickThroughRate`:
    ``compute()`` returns ``(lifetime, windowed)`` when ``enable_lifetime``
    (the default), else the windowed value alone, each ``(num_tasks,)``."""

    _LIFETIME_STATES = ("weighted_input_sum", "weighted_label_sum")

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        window_size: int = 100,
        enable_lifetime: bool = True,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _check_num_tasks(num_tasks)
        self.num_tasks = num_tasks
        self.enable_lifetime = enable_lifetime
        if enable_lifetime:
            for name in self._LIFETIME_STATES:
                self._add_state(name, zeros_state((num_tasks,)), reduction=Reduction.SUM)
        self._init_window(window_size)

    def update(self, input, target, weight: Weights = None) -> "WindowedWeightedCalibration":
        pred, label = _fold_calibration(self, input, target, weight)
        if self.enable_lifetime:
            self.weighted_input_sum = self.weighted_input_sum + pred
            self.weighted_label_sum = self.weighted_label_sum + label
        self._push_window(pred, label)
        return self

    def compute(self):
        pred, label = self._window_totals()
        windowed = _calibration_compute(pred, label)
        if not self.enable_lifetime:
            return windowed
        return _calibration_compute(self.weighted_input_sum, self.weighted_label_sum), windowed

    def merge_state(
        self, metrics: Iterable["WindowedWeightedCalibration"]
    ) -> "WindowedWeightedCalibration":
        self._merge_windowed(metrics)
        return self
