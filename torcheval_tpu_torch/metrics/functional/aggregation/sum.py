"""Weighted sum.

JAX counterpart: ``torcheval_tpu/metrics/functional/aggregation/sum.py``.
"""

from __future__ import annotations

from typing import Union

import torch

from torcheval_tpu_torch.utils.convert import as_tensor


def _sum_update(input: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return torch.sum(input * weight)


def _weight_check(input: torch.Tensor, weight) -> torch.Tensor:
    """``weight`` as a float32 tensor on ``input``'s device: a scalar or an
    array of ``input``'s shape."""
    weight = as_tensor(weight, input.device, torch.float32)
    if weight.ndim != 0 and weight.shape != input.shape:
        raise ValueError(
            "weight must be a scalar or an array whose shape matches input "
            f"(input {tuple(input.shape)}, weight {tuple(weight.shape)})."
        )
    return weight


def sum(  # noqa: A001 - the reference API's name
    input,
    weight: Union[float, int, torch.Tensor] = 1.0,
) -> torch.Tensor:
    """The weighted sum of ``input``; runs where ``input`` is."""
    input = as_tensor(input)
    weight = _weight_check(input, weight)
    return _sum_update(input, weight)
