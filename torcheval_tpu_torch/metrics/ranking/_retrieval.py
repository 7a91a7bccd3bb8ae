"""Shared base of the retrieval metrics (NDCG@k, MAP@k, Recall@k).

JAX counterpart: ``torcheval_tpu/metrics/ranking/_retrieval.py``. They are
means over valid rows, so their state is two scalars: ``score_sum``
(float32) and ``num_valid`` (int32), both ``Reduction.SUM``. The label axis
lives only inside the top-k engine call of each update, never in state. The
JAX classes defer their folds; here ``update()`` folds each batch at once,
with the same state.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics.functional.ranking.retrieval import (
    _retrieval_input_check,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.ops.topk import _METHODS as _TOPK_METHODS
from torcheval_tpu_torch.utils.devices import DeviceLike


class RetrievalMeanMetric(Metric[torch.Tensor]):
    """Mean of a per-sample retrieval score over the rows where it is not
    NaN. Subclasses set ``_kernel``, a function of ``(input, target, k,
    topk_method)`` from ``functional/ranking/retrieval.py``."""

    _kernel = None

    def __init__(
        self,
        *,
        k: Optional[int] = None,
        topk_method: str = "auto",
        device: DeviceLike = None,
    ) -> None:
        if k is not None and (type(k) is not int or k <= 0):
            raise ValueError(f"k should be None or a positive int, got {k!r}.")
        if topk_method not in _TOPK_METHODS:
            raise ValueError(
                f"topk_method must be one of {_TOPK_METHODS}, got {topk_method!r}."
            )
        super().__init__(device=device)
        self.k = k
        self.topk_method = topk_method
        self._add_state(
            "score_sum", zeros_state((), dtype=torch.float32), reduction=Reduction.SUM
        )
        self._add_state(
            "num_valid", zeros_state((), dtype=torch.int32), reduction=Reduction.SUM
        )

    def update(self, input, target):
        input, target = self._input(input), self._input(target)
        _retrieval_input_check(input, target, self.k)
        per_sample = self._kernel(input, target, self.k, self.topk_method)
        valid = ~torch.isnan(per_sample)
        self.score_sum += torch.sum(torch.where(valid, per_sample, 0.0))
        self.num_valid += valid.sum(dtype=torch.int32)
        return self

    def compute(self) -> torch.Tensor:
        """The mean over valid rows; NaN before the first valid row."""
        return torch.where(
            self.num_valid > 0,
            self.score_sum / torch.clamp(self.num_valid, min=1).to(torch.float32),
            torch.nan,
        )

    def merge_state(self, metrics: Iterable["RetrievalMeanMetric"]):
        for metric in metrics:
            self.score_sum = self.score_sum + metric.score_sum.to(self._device)
            self.num_valid = self.num_valid + metric.num_valid.to(self._device)
        return self
