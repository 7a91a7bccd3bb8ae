"""Min metric.

JAX counterpart: ``torcheval_tpu/metrics/aggregation/min.py``. The fold
threads state through ``torch.minimum`` (``_fold_reduce``); see
:mod:`.max`, which also holds the weakly typed default both share.
"""

from __future__ import annotations

import torch

from torcheval_tpu_torch.metrics.aggregation.max import _ExtremumMetric


def _min_deferred_fold(input):
    return {"min": torch.min(input)}


def _min_deferred_compute(min):  # noqa: A002 - the state's name
    return min


class Min(_ExtremumMetric):
    """Streaming minimum over all seen elements (+inf before any update,
    float32 or the first batch's floating type; NaN propagates)."""

    _fold_fn = staticmethod(_min_deferred_fold)
    _fold_reduce = staticmethod(torch.minimum)
    _compute_fn = staticmethod(_min_deferred_compute)
    _state_name = "min"
    _identity = float("inf")
