"""Dummy metrics, one for each state container type.

JAX counterpart: ``torcheval_tpu/utils/test_utils/dummy_metric.py``: a
tensor, a list, a dict and a deque state, for the base-class and toolkit
tests.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable

import torch

from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction
from torcheval_tpu_torch.utils.devices import DeviceLike


def _zero(device: torch.device) -> torch.Tensor:
    return torch.zeros((), device=device)


class DummySumMetric(Metric[torch.Tensor]):
    """Scalar tensor state: running sum."""

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("sum", torch.zeros(()), reduction=Reduction.SUM)

    def update(self, x) -> "DummySumMetric":
        self.sum = self.sum + torch.sum(self._input(x)).to(self.sum.dtype)
        return self

    def compute(self) -> torch.Tensor:
        return self.sum

    def merge_state(self, metrics: Iterable["DummySumMetric"]) -> "DummySumMetric":
        for metric in metrics:
            self.sum = self.sum + metric.sum.to(self._device)
        return self


class DummySumListStateMetric(Metric[torch.Tensor]):
    """List-of-tensors state: caches every update."""

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("x", [], reduction=Reduction.CAT)

    def update(self, x) -> "DummySumListStateMetric":
        self.x.append(self._input(x))
        return self

    def compute(self) -> torch.Tensor:
        return torch.stack(self.x).sum() if self.x else _zero(self._device)

    def merge_state(
        self, metrics: Iterable["DummySumListStateMetric"]
    ) -> "DummySumListStateMetric":
        for metric in metrics:
            self.x.extend(x.to(self._device) for x in metric.x)
        return self

    def _prepare_for_merge_state(self) -> None:
        if self.x:
            self.x = [torch.stack([v.to(torch.float32) for v in self.x]).sum()]


class DummySumDictStateMetric(Metric[torch.Tensor]):
    """Dict-keyed state, synced through the object lane."""

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("x", {}, reduction=Reduction.CUSTOM)

    def update(self, key: str, x) -> "DummySumDictStateMetric":
        self.x[key] = self.x.get(key, _zero(self._device)) + torch.sum(self._input(x))
        return self

    def compute(self) -> torch.Tensor:
        return torch.stack(list(self.x.values())).sum() if self.x else _zero(self._device)

    def merge_state(
        self, metrics: Iterable["DummySumDictStateMetric"]
    ) -> "DummySumDictStateMetric":
        for metric in metrics:
            for k, v in metric.x.items():
                self.x[k] = self.x.get(k, _zero(self._device)) + v.to(self._device)
        return self


class DummySumDequeStateMetric(Metric[torch.Tensor]):
    """Deque state with a bounded window."""

    def __init__(self, *, maxlen: int = 10, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("x", deque(maxlen=maxlen), reduction=Reduction.CAT)

    def update(self, x) -> "DummySumDequeStateMetric":
        self.x.append(self._input(x))
        return self

    def compute(self) -> torch.Tensor:
        return torch.stack(list(self.x)).sum() if self.x else _zero(self._device)

    def merge_state(
        self, metrics: Iterable["DummySumDequeStateMetric"]
    ) -> "DummySumDequeStateMetric":
        for metric in metrics:
            self.x.extend(x.to(self._device) for x in metric.x)
        return self
