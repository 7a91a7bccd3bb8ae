"""Weighted calibration: predicted positives over observed positives.

JAX counterpart:
``torcheval_tpu/metrics/functional/classification/weighted_calibration.py``.
``calibration = sum(weight * input) / sum(weight * target)`` per task (1.0
is perfectly calibrated, above 1 over-predicts), ``0.0`` where no positive
label has been seen. Both sufficient statistics merge by sum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional.classification._task_shapes import (
    check_task_shape,
)
from torcheval_tpu_torch.metrics.functional.classification.click_through_rate import (
    Weights,
    _as_f32,
)
from torcheval_tpu_torch.utils.convert import as_tensor
from torcheval_tpu_torch.utils.numerics import safe_div


def _calibration_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
    num_tasks: int,
    weight: Optional[torch.Tensor],
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            f"`input` shape ({tuple(input.shape)}) is different from `target` shape "
            f"({tuple(target.shape)})"
        )
    if weight is not None and getattr(weight, "ndim", 0) and input.shape != weight.shape:
        raise ValueError(
            f"`weight` shape ({tuple(weight.shape)}) is different from `input` "
            f"shape ({tuple(input.shape)})"
        )
    check_task_shape(input, num_tasks)


def _calibration_fold(
    input: torch.Tensor, target: torch.Tensor, weight
) -> Tuple[torch.Tensor, torch.Tensor]:
    input = input.to(torch.float32)
    target = target.to(torch.float32)
    w = torch.broadcast_to(_as_f32(weight, input), input.shape)
    return torch.sum(w * input, dim=-1), torch.sum(w * target, dim=-1)


def _weighted_calibration_update(
    input: torch.Tensor, target: torch.Tensor, num_tasks: int, weight: Weights
) -> Tuple[torch.Tensor, torch.Tensor]:
    if weight is None:
        weight = 1.0
    elif not isinstance(weight, (int, float)):
        # converted before the check: a Python list has no shape
        weight = as_tensor(weight, input.device)
    _calibration_input_check(input, target, num_tasks, weight if hasattr(weight, "shape") else None)
    return _calibration_fold(input, target, weight)


def _calibration_compute(
    weighted_input_sum: torch.Tensor, weighted_label_sum: torch.Tensor
) -> torch.Tensor:
    # 0.0 where there is no positive label mass
    return safe_div(weighted_input_sum, weighted_label_sum)


def weighted_calibration(
    input, target, weight: Weights = None, *, num_tasks: int = 1
) -> torch.Tensor:
    """``sum(weight * input) / sum(weight * target)`` per task, of predicted
    probabilities ``input`` and binary labels ``target``, shape
    ``(num_samples,)`` or ``(num_tasks, num_samples)``, with optional
    weights (a scalar or the same shape; default 1). ``0.0`` per task where
    no positive label mass has been seen. Runs where ``input`` is."""
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    pred, label = _weighted_calibration_update(input, target, num_tasks, weight)
    return _calibration_compute(pred, label)
