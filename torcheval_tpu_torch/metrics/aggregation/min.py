"""Min metric.

JAX counterpart: ``torcheval_tpu/metrics/aggregation/min.py``. The fold
threads state through ``torch.minimum`` (``_fold_reduce``); see
:mod:`.max`.
"""

from __future__ import annotations

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction
from torcheval_tpu_torch.utils.devices import DeviceLike


def _min_deferred_fold(input):
    return {"min": torch.min(input)}


def _min_deferred_compute(min):  # noqa: A002 - the state's name
    return min


class Min(DeferredFoldMixin, Metric[torch.Tensor]):
    """Streaming minimum over all seen elements (float32 state, +inf before
    any update; NaN propagates)."""

    _fold_fn = staticmethod(_min_deferred_fold)
    _fold_reduce = staticmethod(torch.minimum)
    _compute_fn = staticmethod(_min_deferred_compute)

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("min", torch.tensor(float("inf")), reduction=Reduction.MIN)

    def update(self, input) -> "Min":
        self._defer(self._input(input))
        return self

    def compute(self) -> torch.Tensor:
        return self._deferred_compute()

    def merge_state(self, metrics: Iterable["Min"]) -> "Min":
        for metric in metrics:
            self.min = torch.minimum(self.min, metric.min.to(self._device))
        return self
