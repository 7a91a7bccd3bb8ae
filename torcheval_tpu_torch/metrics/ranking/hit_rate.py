"""HitRate metric.

JAX counterpart: ``torcheval_tpu/metrics/ranking/hit_rate.py``. Per-sample
scores are computed at update time and cached, one float per sample;
``compute()`` concatenates them. Exact mode only: the JAX package's
``approx=`` (a resident value sketch) comes with the sketch slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional.ranking.hit_rate import hit_rate
from torcheval_tpu_torch.metrics.sample_cache import SampleCacheMetric
from torcheval_tpu_torch.utils.devices import DeviceLike


class HitRate(SampleCacheMetric[torch.Tensor]):
    """Per-sample hit rate of the target class among the top-``k`` scores.

    Args:
        k: top-k cutoff; ``None`` considers all classes (hit rate 1.0).

    ``compute()`` returns the per-sample scores of every update, in order
    (an empty float32 tensor before the first).
    """

    def __init__(self, *, k: Optional[int] = None, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        if k is not None and k <= 0:
            raise ValueError(f"k should be None or positive, got {k}.")
        self.k = k
        self._add_cache_state("scores")

    def update(self, input, target) -> "HitRate":
        input, target = self._input(input), self._input(target)
        self.scores.append(hit_rate(input, target, k=self.k))
        return self

    def compute(self) -> torch.Tensor:
        return self._concat_cache("scores")
