"""Mean metric.

JAX counterpart: ``torcheval_tpu/metrics/aggregation/mean.py``, with its fix
of the reference: the reference takes an exactly-zero ``weighted_sum`` as
"no updates yet" and returns 0.0 for data whose mean is zero; here, as in
the JAX package, ``weights == 0`` is the no-update signal.
"""

from __future__ import annotations

import logging
from typing import Iterable, Union

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.functional.aggregation.mean import _mean_update
from torcheval_tpu_torch.metrics.functional.aggregation.sum import _weight_check
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.utils.devices import DeviceLike
from torcheval_tpu_torch.utils.numerics import safe_div
from torcheval_tpu_torch.utils.tracing import async_value_warn

_logger = logging.getLogger(__name__)


def _mean_deferred_fold(input, weight=None):
    if weight is None:
        return {
            "weighted_sum": torch.sum(input),
            "weights": torch.full((), float(input.numel()), dtype=torch.float32, device=input.device),
        }
    weighted_sum, total_weight = _mean_update(input, weight)
    return {"weighted_sum": weighted_sum, "weights": total_weight}


def _mean_deferred_compute(weighted_sum, weights):
    return safe_div(weighted_sum, weights)


class Mean(DeferredFoldMixin, Metric[torch.Tensor]):
    """Streaming weighted mean ``sum(weight * input) / sum(weight)``; state
    is two float32 scalars. With no update, compute returns 0.0 and logs a
    warning a moment later (``weights`` is read on a daemon thread)."""

    _fold_fn = staticmethod(_mean_deferred_fold)
    _fold_per_chunk = True
    _compute_fn = staticmethod(_mean_deferred_compute)

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("weighted_sum", zeros_state(), reduction=Reduction.SUM)
        self._add_state("weights", zeros_state(), reduction=Reduction.SUM)
        self._init_deferred()

    def update(self, input, *, weight: Union[float, int, torch.Tensor] = 1.0) -> "Mean":
        input = self._input(input)
        if isinstance(weight, (int, float)) and weight == 1.0:
            self._defer(input)
        else:
            self._defer(input, _weight_check(input, weight))
        return self

    def _on_window_result(self, result):
        # the folded weights are read on a daemon thread (utils/tracing.py)
        def _check(w) -> None:
            if w == 0.0:
                _logger.warning("No calls to update() have been made - returning 0.0")

        async_value_warn(_check, self.weights)
        return result

    def compute(self) -> torch.Tensor:
        return self._deferred_compute()

    def merge_state(self, metrics: Iterable["Mean"]) -> "Mean":
        metrics = self._fold_for_merge(metrics)
        for metric in metrics:
            self.weighted_sum = self.weighted_sum + metric.weighted_sum.to(self._device)
            self.weights = self.weights + metric.weights.to(self._device)
        return self
