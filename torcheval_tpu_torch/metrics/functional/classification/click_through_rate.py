"""Click-through rate: the weighted click frequency.

JAX counterpart:
``torcheval_tpu/metrics/functional/classification/click_through_rate.py``.
``ctr = sum(weight * clicks) / sum(weight)`` per task, ``0.0`` when no
weight has been seen. The sufficient statistics, ``click_total`` and
``weight_total``, both merge by sum.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from torcheval_tpu_torch.metrics.functional.classification._task_shapes import (
    check_task_shape,
)
from torcheval_tpu_torch.utils.convert import as_tensor
from torcheval_tpu_torch.utils.numerics import safe_div

Weights = Union[float, int, torch.Tensor, None]


def _ctr_input_check(
    input: torch.Tensor, num_tasks: int, weights: Optional[torch.Tensor]
) -> None:
    if weights is not None and getattr(weights, "ndim", 0) and input.shape != weights.shape:
        raise ValueError(
            f"`weights` shape ({tuple(weights.shape)}) is different from `input` "
            f"shape ({tuple(input.shape)})"
        )
    check_task_shape(input, num_tasks)


def _as_f32(w, like: torch.Tensor) -> torch.Tensor:
    """A weight (a tensor or a Python number) as float32 beside ``like``."""
    if isinstance(w, torch.Tensor):
        return w.to(torch.float32)
    return torch.full((), float(w), dtype=torch.float32, device=like.device)


def _ctr_fold(input: torch.Tensor, weights) -> Tuple[torch.Tensor, torch.Tensor]:
    input = input.to(torch.float32)
    w = torch.broadcast_to(_as_f32(weights, input), input.shape)
    return torch.sum(w * input, dim=-1), torch.sum(w, dim=-1)


def _click_through_rate_update(
    input: torch.Tensor, num_tasks: int, weights: Weights
) -> Tuple[torch.Tensor, torch.Tensor]:
    if weights is None:
        weights = 1.0
    elif not isinstance(weights, (int, float)):
        # converted before the check: a Python list has no shape
        weights = as_tensor(weights, input.device)
    _ctr_input_check(input, num_tasks, weights if hasattr(weights, "shape") else None)
    return _ctr_fold(input, weights)


def _ctr_compute(click_total: torch.Tensor, weight_total: torch.Tensor) -> torch.Tensor:
    # 0.0 where nothing was weighed in
    return safe_div(click_total, weight_total)


def click_through_rate(input, weights: Weights = None, *, num_tasks: int = 1) -> torch.Tensor:
    """``sum(weights * input) / sum(weights)``, the weighted click rate, of
    click indicators ``input`` (0/1) of shape ``(num_samples,)`` or
    ``(num_tasks, num_samples)``, with optional weights (a scalar or the
    shape of ``input``; default 1). ``0.0`` per task where the total weight
    is zero. Runs where ``input`` is."""
    input = as_tensor(input)
    clicks, total = _click_through_rate_update(input, num_tasks, weights)
    return _ctr_compute(clicks, total)
