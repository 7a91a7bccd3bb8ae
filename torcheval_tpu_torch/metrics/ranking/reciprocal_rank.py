"""ReciprocalRank metric.

JAX counterpart: ``torcheval_tpu/metrics/ranking/reciprocal_rank.py``. A
per-sample cache as in ``ranking/hit_rate.py``; exact mode only (the JAX
package's ``approx=`` comes with the sketch slice).
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional.ranking.reciprocal_rank import reciprocal_rank
from torcheval_tpu_torch.metrics.sample_cache import SampleCacheMetric
from torcheval_tpu_torch.utils.devices import DeviceLike


class ReciprocalRank(SampleCacheMetric[torch.Tensor]):
    """Per-sample ``1 / (rank + 1)`` of the target class (0 beyond ``k``).

    Args:
        k: optional top-k cutoff. With more than 1024 classes on a CUDA
            tensor and ``k <= 128``, the rank is counted against the top-k
            kernel's values.
    """

    def __init__(self, *, k: Optional[int] = None, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        if k is not None and k <= 0:
            raise ValueError(f"k should be None or positive, got {k}.")
        self.k = k
        self._add_cache_state("scores")

    def update(self, input, target) -> "ReciprocalRank":
        input, target = self._input(input), self._input(target)
        self.scores.append(reciprocal_rank(input, target, k=self.k))
        return self

    def compute(self) -> torch.Tensor:
        return self._concat_cache("scores")
