"""Max metric.

JAX counterpart: ``torcheval_tpu/metrics/aggregation/max.py``. The running
maximum is not additive, so the fold threads state through
``torch.maximum`` (``_fold_reduce``) instead of an add.
"""

from __future__ import annotations

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction
from torcheval_tpu_torch.utils.devices import DeviceLike


def _max_deferred_fold(input):
    return {"max": torch.max(input)}


def _max_deferred_compute(max):  # noqa: A002 - the state's name
    return max


class Max(DeferredFoldMixin, Metric[torch.Tensor]):
    """Streaming maximum over all seen elements (float32 state, -inf before
    any update; NaN propagates)."""

    _fold_fn = staticmethod(_max_deferred_fold)
    _fold_reduce = staticmethod(torch.maximum)
    _compute_fn = staticmethod(_max_deferred_compute)

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("max", torch.tensor(float("-inf")), reduction=Reduction.MAX)

    def update(self, input) -> "Max":
        self._defer(self._input(input))
        return self

    def compute(self) -> torch.Tensor:
        return self._deferred_compute()

    def merge_state(self, metrics: Iterable["Max"]) -> "Max":
        for metric in metrics:
            self.max = torch.maximum(self.max, metric.max.to(self._device))
        return self
