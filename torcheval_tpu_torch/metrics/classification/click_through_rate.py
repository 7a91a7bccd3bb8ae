"""ClickThroughRate and its windowed variant.

JAX counterpart: ``torcheval_tpu/metrics/classification/click_through_rate.py``.
``ClickThroughRate`` is deferred (``metrics/deferred.py``): updates append,
and the weighted-count fold runs in the shared window step.
``WindowedClickThroughRate`` folds each update eagerly, since its window
keeps every update as its own ``(clicks, weight)`` row, which a fold over
many batches would merge; the window mechanics are in :mod:`._windowed`,
shared with the calibration variant.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from torcheval_tpu_torch.metrics.classification._windowed import WindowedStateMixin
from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.functional.classification._task_shapes import (
    check_num_tasks as _check_num_tasks,
)
from torcheval_tpu_torch.metrics.functional.classification.click_through_rate import (
    Weights,
    _click_through_rate_update,
    _ctr_compute,
    _ctr_fold,
    _ctr_input_check,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.utils.devices import DeviceLike


def _fold_ctr(metric, input, weights):
    """Place the inputs, fold and reshape to ``(num_tasks,)`` (the fold
    gives scalars at ``num_tasks=1``): the windowed class's eager update."""
    input = metric._input(input)
    if weights is not None and hasattr(weights, "shape"):
        weights = metric._input(weights)
    clicks, total = _click_through_rate_update(input, metric.num_tasks, weights)
    return clicks.reshape(metric.num_tasks), total.reshape(metric.num_tasks)


# A weighted update defers its weights as a second column, so the trailing
# parameters are read by arity: rest is (num_tasks,) or (weights, num_tasks).
def _ctr_deferred_fold(input, *rest):
    num_tasks = rest[-1]
    weights = rest[0] if len(rest) == 2 else 1.0
    clicks, total = _ctr_fold(input, weights)
    return {"click_total": clicks.reshape(num_tasks), "weight_total": total.reshape(num_tasks)}


class ClickThroughRate(DeferredFoldMixin, Metric[torch.Tensor]):
    """Streaming weighted click-through rate: ``compute()`` returns
    ``sum(w * clicks) / sum(w)`` with shape ``(num_tasks,)`` (``0.0`` per
    task before any weighted update)."""

    _fold_fn = staticmethod(_ctr_deferred_fold)
    _fold_per_chunk = True
    _compute_fn = staticmethod(_ctr_compute)

    def __init__(self, *, num_tasks: int = 1, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        _check_num_tasks(num_tasks)
        self.num_tasks = num_tasks
        for name in ("click_total", "weight_total"):
            self._add_state(name, zeros_state((num_tasks,)), reduction=Reduction.SUM)
        self._init_deferred()
        self._fold_params = (num_tasks,)

    def update(self, input, weights: Weights = None) -> "ClickThroughRate":
        input = self._input(input)
        if weights is None:
            _ctr_input_check(input, self.num_tasks, None)
            self._defer(input)
            return self
        # a scalar weight becomes a 0-d column, broadcast in the fold
        weights = self._input(weights)
        _ctr_input_check(input, self.num_tasks, weights if weights.ndim else None)
        self._defer(input, weights)
        return self

    def compute(self) -> torch.Tensor:
        return self._deferred_compute()

    def merge_state(self, metrics: Iterable["ClickThroughRate"]) -> "ClickThroughRate":
        for metric in self._fold_for_merge(metrics):
            self.click_total = self.click_total + metric.click_total.to(self._device)
            self.weight_total = self.weight_total + metric.weight_total.to(self._device)
        return self


class WindowedClickThroughRate(WindowedStateMixin, Metric[Tuple[torch.Tensor, torch.Tensor]]):
    """CTR over the last ``window_size`` updates, and over the whole stream.

    The window is a ``deque(maxlen=window_size)`` of per-update ``(2,
    num_tasks)`` rows ``[clicks, weight]``; the oldest update falls out.
    ``merge_state`` appends the other replicas' rows after this one's, and
    the lifetime counters merge by sum; replicas must share the window's
    configuration. ``compute()`` returns ``(lifetime_ctr, windowed_ctr)``
    when ``enable_lifetime`` (the default), else the windowed rate alone,
    each of shape ``(num_tasks,)``."""

    _LIFETIME_STATES = ("click_total", "weight_total")

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

    def update(self, input, weights: Weights = None) -> "WindowedClickThroughRate":
        clicks, total = _fold_ctr(self, input, weights)
        if self.enable_lifetime:
            self.click_total = self.click_total + clicks
            self.weight_total = self.weight_total + total
        self._push_window(clicks, total)
        return self

    def compute(self):
        clicks, total = self._window_totals()
        windowed = _ctr_compute(clicks, total)
        if not self.enable_lifetime:
            return windowed
        return _ctr_compute(self.click_total, self.weight_total), windowed

    def merge_state(
        self, metrics: Iterable["WindowedClickThroughRate"]
    ) -> "WindowedClickThroughRate":
        self._merge_windowed(metrics)
        return self
