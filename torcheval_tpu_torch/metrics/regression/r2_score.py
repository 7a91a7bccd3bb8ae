"""R2Score.

JAX counterpart: ``torcheval_tpu/metrics/regression/r2_score.py``. Updates
are deferred (``metrics/deferred.py``): the four sufficient statistics
fold over the pending batches at the next read of the state, shared with
every other deferring member of a ``MetricCollection``.
"""

from __future__ import annotations

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.functional.regression.r2_score import (
    _r2_fold,
    _r2_score_compute,
    _r2_score_param_check,
    _r2_score_update_input_check,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.utils.devices import DeviceLike

_STATE_NAMES = ("sum_squared_obs", "sum_obs", "sum_squared_residual", "num_obs")


def _r2_deferred_fold(input, target):
    return dict(zip(_STATE_NAMES, _r2_fold(input, target)))


class R2Score(DeferredFoldMixin, Metric[torch.Tensor]):
    """Streaming R-squared score over four sufficient statistics;
    ``multioutput`` is ``"uniform_average"`` (the default), ``"raw_values"``
    or ``"variance_weighted"``, and ``num_regressors`` (0: plain R^2) gives
    the adjusted score."""

    _fold_fn = staticmethod(_r2_deferred_fold)
    _fold_per_chunk = True

    def __init__(
        self,
        *,
        multioutput: str = "uniform_average",
        num_regressors: int = 0,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _r2_score_param_check(multioutput, num_regressors)
        self.multioutput = multioutput
        self.num_regressors = num_regressors
        for name in _STATE_NAMES:
            # num_obs counts in int32 (exact to 2^31 samples)
            default = zeros_state((), dtype=torch.int32) if name == "num_obs" else zeros_state()
            self._add_state(name, default, reduction=Reduction.SUM)
        self._init_deferred()

    def _update_check(self, input, target) -> None:
        _r2_score_update_input_check(input, target)

    def update(self, input, target) -> "R2Score":
        self._defer(self._input(input), self._input(target))
        return self

    # no _compute_fn: the compute reads num_obs on the host for its
    # insufficient-data errors, so it cannot ride the window step
    def compute(self) -> torch.Tensor:
        self._fold_now()
        return _r2_score_compute(
            self.sum_squared_obs,
            self.sum_obs,
            self.sum_squared_residual,
            self.num_obs,
            self.multioutput,
            self.num_regressors,
        )

    def merge_state(self, metrics: Iterable["R2Score"]) -> "R2Score":
        for metric in self._fold_for_merge(metrics):
            for name in _STATE_NAMES:
                setattr(self, name, getattr(self, name) + getattr(metric, name).to(self._device))
        return self
