"""Weighted mean.

JAX counterpart: ``torcheval_tpu/metrics/functional/aggregation/mean.py``.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from torcheval_tpu_torch.metrics.functional.aggregation.sum import _weight_check, _weighted
from torcheval_tpu_torch.utils.convert import as_tensor


def _mean_update(
    input: torch.Tensor, weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    weighted_sum = torch.sum(_weighted(input, weight))
    if weight.ndim == 0:
        total_weight = weight * input.numel()
    else:
        total_weight = torch.sum(weight)
    return weighted_sum, total_weight


def mean(
    input,
    weight: Union[float, int, torch.Tensor] = 1.0,
) -> torch.Tensor:
    """The weighted mean ``sum(weight * input) / sum(weight)``; runs where
    ``input`` is."""
    input = as_tensor(input)
    weight = _weight_check(input, weight)
    weighted_sum, total_weight = _mean_update(input, weight)
    return weighted_sum / total_weight
