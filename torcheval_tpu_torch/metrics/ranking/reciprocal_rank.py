"""ReciprocalRank metric.

JAX counterpart: ``torcheval_tpu/metrics/ranking/reciprocal_rank.py``. A
per-sample cache as in ``ranking/hit_rate.py``. With ``approx=`` the cache
becomes a resident value sketch and ``compute()`` returns the mean
reciprocal rank (MRR) within ``sketch.relative_error(bits)``, the contract
of ``ranking/hit_rate.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional.ranking.reciprocal_rank import reciprocal_rank
from torcheval_tpu_torch.metrics.sample_cache import SampleCacheMetric
from torcheval_tpu_torch.sketch.buckets import DEFAULT_BUCKET_BITS
from torcheval_tpu_torch.sketch.cache import (
    ValueSketchCacheMixin,
    raise_sketch_overflow,
    resolve_approx,
)
from torcheval_tpu_torch.sketch.histogram import mean_from_counts
from torcheval_tpu_torch.utils.devices import DeviceLike


class ReciprocalRank(ValueSketchCacheMixin, SampleCacheMetric[torch.Tensor]):
    """Per-sample ``1 / (rank + 1)`` of the target class (0 beyond ``k``).

    Args:
        k: optional top-k cutoff. With more than 1024 classes on a CUDA
            tensor and ``k <= 128``, the rank is counted against the top-k
            kernel's values.
        approx: keep a resident value sketch instead of the per-sample
            cache; ``compute()`` then returns the mean (module doc).
    """

    def __init__(
        self, *, k: Optional[int] = None, approx=None, device: DeviceLike = None
    ) -> None:
        super().__init__(device=device)
        if k is not None and k <= 0:
            raise ValueError(f"k should be None or positive, got {k}.")
        self.k = k
        self._add_cache_state("scores")
        bits = resolve_approx(approx, default_bits=DEFAULT_BUCKET_BITS)
        if bits is not None:
            self._init_value_sketch(bits, "scores")

    def update(self, input, target) -> "ReciprocalRank":
        input, target = self._input(input), self._input(target)
        batch = reciprocal_rank(input, target, k=self.k)
        self.scores.append(batch)
        if self._sketch_enabled():
            self._sketch_stage(batch)
        return self

    def compute(self) -> torch.Tensor:
        if self._sketch_enabled():
            counts, nan, overflow = self._sketch_counts_parts()
            result = mean_from_counts(counts, self._sketch_bits)
            raise_sketch_overflow(overflow)
            self._sketch_check_nan(nan)
            return result
        return self._concat_cache("scores")
