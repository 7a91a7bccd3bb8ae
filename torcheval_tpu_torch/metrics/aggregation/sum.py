"""Sum metric.

JAX counterpart: ``torcheval_tpu/metrics/aggregation/sum.py``. The fold is
the module-level :func:`_sum_deferred_fold` (``metrics/deferred.py``); a
non-default weight is a second update column, and the fold tells the two
apart by arity.
"""

from __future__ import annotations

from typing import Iterable, Union

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.functional.aggregation.sum import _sum_update, _weight_check
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.utils.devices import DeviceLike


def _sum_deferred_fold(input, weight=None):
    if weight is None:
        return {"weighted_sum": torch.sum(input)}
    return {"weighted_sum": _sum_update(input, weight)}


def _sum_deferred_compute(weighted_sum):
    return weighted_sum


class Sum(DeferredFoldMixin, Metric[torch.Tensor]):
    """Streaming (weighted) sum; state is one float32 scalar."""

    _fold_fn = staticmethod(_sum_deferred_fold)
    _fold_per_chunk = True
    _compute_fn = staticmethod(_sum_deferred_compute)

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("weighted_sum", zeros_state(), reduction=Reduction.SUM)
        self._init_deferred()

    def update(self, input, *, weight: Union[float, int, torch.Tensor] = 1.0) -> "Sum":
        input = self._input(input)
        if isinstance(weight, (int, float)) and weight == 1.0:
            self._defer(input)
        else:
            self._defer(input, _weight_check(input, weight))
        return self

    def compute(self) -> torch.Tensor:
        return self._deferred_compute()

    def merge_state(self, metrics: Iterable["Sum"]) -> "Sum":
        metrics = self._fold_for_merge(metrics)
        for metric in metrics:
            self.weighted_sum = self.weighted_sum + metric.weighted_sum.to(self._device)
        return self
