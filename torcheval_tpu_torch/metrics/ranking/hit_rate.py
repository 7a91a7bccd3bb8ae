"""HitRate metric.

JAX counterpart: ``torcheval_tpu/metrics/ranking/hit_rate.py``. Per-sample
scores are computed at update time and cached, one float per sample;
``compute()`` concatenates them.

With ``approx=`` (or the ``TORCHEVAL_TPU_APPROX`` environment variable) the
per-sample cache becomes a resident value sketch (``sketch/``): O(buckets)
memory for any stream length. The per-sample vector is then gone, so
``compute()`` returns the mean hit rate, estimated from the sketch within
``sketch.relative_error(bits)``; merges add buckets.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional.ranking.hit_rate import hit_rate
from torcheval_tpu_torch.metrics.sample_cache import SampleCacheMetric
from torcheval_tpu_torch.sketch.buckets import DEFAULT_BUCKET_BITS
from torcheval_tpu_torch.sketch.cache import (
    ValueSketchCacheMixin,
    raise_sketch_overflow,
    resolve_approx,
)
from torcheval_tpu_torch.sketch.histogram import mean_from_counts
from torcheval_tpu_torch.utils.devices import DeviceLike


class HitRate(ValueSketchCacheMixin, SampleCacheMetric[torch.Tensor]):
    """Per-sample hit rate of the target class among the top-``k`` scores.

    Args:
        k: top-k cutoff; ``None`` considers all classes (hit rate 1.0).
        approx: keep a resident value sketch instead of the per-sample
            cache; ``compute()`` then returns the mean (module doc).

    ``compute()`` returns the per-sample scores of every update, in order
    (an empty float32 tensor before the first).
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

    def update(self, input, target) -> "HitRate":
        input, target = self._input(input), self._input(target)
        batch = hit_rate(input, target, k=self.k)
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
