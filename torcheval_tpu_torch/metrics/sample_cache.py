"""Shared base for sample-cache metrics (list-of-tensors state).

JAX counterpart: ``torcheval_tpu/metrics/sample_cache.py``. Subclasses
register append-only caches with :meth:`_add_cache_state`; this base gives
the concatenating merge and the pre-sync compaction to one buffer per cache.
"""

from __future__ import annotations

from typing import Iterable, List, TypeVar

import torch

from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction

TComputeReturn = TypeVar("TComputeReturn")
TSelf = TypeVar("TSelf", bound="SampleCacheMetric")


class SampleCacheMetric(Metric[TComputeReturn]):
    """Metric whose state variables are lists of tensors concatenated on axis 0."""

    def _add_cache_state(self, name: str) -> None:
        """Register a CAT cache."""
        self._add_state(name, [], reduction=Reduction.CAT)

    def _concat_cache(self, name: str, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Cache ``name`` concatenated on axis 0; an empty cache gives an
        empty ``dtype`` tensor on the metric's device."""
        cache = getattr(self, name)
        if not cache:
            return torch.empty(0, dtype=dtype, device=self._device)
        return torch.cat(cache, dim=0)

    def _cache_names(self) -> List[str]:
        return [
            name
            for name, default in self._state_name_to_default.items()
            if isinstance(default, list)
        ]

    def merge_state(self: TSelf, metrics: Iterable[TSelf]) -> TSelf:
        for metric in metrics:
            for name in self._cache_names():
                src = getattr(metric, name)
                if src:
                    getattr(self, name).append(torch.cat(src, dim=0).to(self._device))
        return self

    def _prepare_for_merge_state(self) -> None:
        for name in self._cache_names():
            cache = getattr(self, name)
            if cache:
                setattr(self, name, [torch.cat(cache, dim=0)])
