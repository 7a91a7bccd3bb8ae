"""MeanSquaredError metric.

JAX counterpart: ``torcheval_tpu/metrics/regression/mean_squared_error.py``.
``sum_squared_error`` starts as a float32 scalar and widens to
``(n_output,)`` on the first 2-D update by broadcasting, as in the JAX
package; ``sum_weight`` is an int32 count that a weighted update turns into
a float32 sum.
"""

from __future__ import annotations

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.functional.regression.mean_squared_error import (
    _mean_squared_error_compute,
    _mean_squared_error_param_check,
    _mean_squared_error_update_input_check,
    _mse_fold,
    _mse_fold_weighted,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.utils.devices import DeviceLike


def _mse_deferred_fold(input, target, sample_weight=None):
    if sample_weight is None:
        sse, sw = _mse_fold(input, target)
    else:
        sse, sw = _mse_fold_weighted(input, target, sample_weight)
    return {"sum_squared_error": sse, "sum_weight": sw}


def _mse_deferred_compute(sum_squared_error, sum_weight, multioutput):
    """The functional compute with its arguments in state order."""
    return _mean_squared_error_compute(sum_squared_error, multioutput, sum_weight)


class MeanSquaredError(DeferredFoldMixin, Metric[torch.Tensor]):
    """Streaming mean squared error with optional per-sample weights;
    ``multioutput`` is ``"uniform_average"`` (default) or
    ``"raw_values"``."""

    _fold_fn = staticmethod(_mse_deferred_fold)
    _fold_per_chunk = True
    _compute_fn = staticmethod(_mse_deferred_compute)

    def __init__(self, *, multioutput: str = "uniform_average", device: DeviceLike = None) -> None:
        super().__init__(device=device)
        _mean_squared_error_param_check(multioutput)
        self.multioutput = multioutput
        self._add_state("sum_squared_error", zeros_state(), reduction=Reduction.SUM)
        self._add_state("sum_weight", zeros_state((), dtype=torch.int32), reduction=Reduction.SUM)
        self._init_deferred()
        self._compute_params = (multioutput,)

    def _update_check(self, input, target, sample_weight=None) -> None:
        _mean_squared_error_update_input_check(input, target, sample_weight)

    def update(self, input, target, *, sample_weight=None) -> "MeanSquaredError":
        input, target = self._input(input), self._input(target)
        if sample_weight is None:
            self._defer(input, target)
        else:
            self._defer(input, target, self._input(sample_weight))
        return self

    def compute(self) -> torch.Tensor:
        return self._deferred_compute()

    def merge_state(self, metrics: Iterable["MeanSquaredError"]) -> "MeanSquaredError":
        metrics = self._fold_for_merge(metrics)
        for metric in metrics:
            self.sum_squared_error = self.sum_squared_error + metric.sum_squared_error.to(
                self._device
            )
            self.sum_weight = self.sum_weight + metric.sum_weight.to(self._device)
        return self
