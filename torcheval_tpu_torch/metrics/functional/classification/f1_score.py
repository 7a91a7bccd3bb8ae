"""F1 score (binary and multiclass).

JAX counterpart: ``torcheval_tpu/metrics/functional/classification/f1_score.py``.
As there: the per-class triple ``(num_tp, num_label, num_prediction)`` comes
from ``ops/confusion.py::match_triple_counts`` (two histogram launches on
the card), classes absent from both targets and predictions are left out
of the macro mean, and the weighted average weighs each class by its
unmasked share of the labels (the reference torcheval's double mask is not
kept). Counters are int32.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.ops.confusion import match_triple_counts
from torcheval_tpu_torch.utils.convert import as_tensor

_logger = logging.getLogger(__name__)

_AVERAGE_OPTIONS = ("micro", "macro", "weighted", None)


def _f1_score_param_check(num_classes: Optional[int], average: Optional[str]) -> None:
    if average not in _AVERAGE_OPTIONS:
        raise ValueError(
            f"`average` was not in the allowed value of {_AVERAGE_OPTIONS}, got {average}."
        )
    if average != "micro" and (num_classes is None or num_classes <= 0):
        raise ValueError(
            f"num_classes should be a positive number when average={average}, "
            f"got num_classes={num_classes}."
        )


def _f1_input_check(
    input: torch.Tensor, target: torch.Tensor, num_classes: Optional[int], name: str
) -> None:
    if input.shape[0] != target.shape[0]:
        raise ValueError(
            "The `input` and `target` should have the same first dimension, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.ndim != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor for {name}, got shape "
            f"{tuple(target.shape)}."
        )
    if not input.ndim == 1 and not (
        input.ndim == 2 and (num_classes is None or input.shape[1] == num_classes)
    ):
        raise ValueError(
            "input should have shape of (num_sample,) or (num_sample, num_classes), "
            f"got {tuple(input.shape)}."
        )


def _binary_f1_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if input.ndim != 1:
        raise ValueError(
            "input should be a one-dimensional tensor for binary f1 score, got shape "
            f"{tuple(input.shape)}."
        )
    if target.ndim != 1:
        raise ValueError(
            "target should be a one-dimensional tensor for binary f1 score, got shape "
            f"{tuple(target.shape)}."
        )
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )


def _f1_score_update(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    average: Optional[str],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if input.ndim == 2:
        input = torch.argmax(input, dim=1)  # first maximum, as jnp.argmax
    if average == "micro":
        # JAX casts both to int32 before comparing
        num_tp = (input.to(torch.int32) == target.to(torch.int32)).sum(dtype=torch.int32)
        n = torch.full((), target.shape[0], dtype=torch.int32, device=target.device)
        return num_tp, n, n
    return match_triple_counts(input, target, num_classes)


def _f1_score_compute(
    num_tp: torch.Tensor,
    num_label: torch.Tensor,
    num_prediction: torch.Tensor,
    average: Optional[str],
) -> torch.Tensor:
    num_tp = num_tp.to(torch.float32)
    num_label = num_label.to(torch.float32)
    num_prediction = num_prediction.to(torch.float32)
    precision = torch.where(
        num_prediction > 0, num_tp / num_prediction.clamp(min=1.0), torch.nan
    )
    recall = torch.where(num_label > 0, num_tp / num_label.clamp(min=1.0), torch.nan)
    f1 = torch.nan_to_num(2 * precision * recall / (precision + recall))
    if average == "micro":
        return f1
    # classes absent from both target and predictions leave the macro mean
    mask = (num_label != 0) | (num_prediction != 0)
    if average == "macro":
        return torch.where(mask, f1, 0.0).sum() / mask.sum().clamp(min=1)
    if average == "weighted":
        weights = num_label / num_label.sum().clamp(min=1.0)
        return (f1 * weights).sum()
    return f1


def _binary_f1_score_update(
    input: torch.Tensor, target: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    pred = torch.where(input < threshold, 0, 1).to(torch.int32)
    num_tp = (pred * target).sum(dtype=torch.int32)
    num_label = target.sum(dtype=torch.int32)
    num_prediction = pred.sum(dtype=torch.int32)
    return num_tp, num_label, num_prediction


def _warn_empty_classes(num_label: torch.Tensor) -> None:
    """Log when some class has no label. Reads ``num_label`` on the host,
    once per compute (the JAX package reads it asynchronously)."""
    if num_label.ndim and bool((num_label == 0).any()):
        _logger.warning(
            "Some classes do not exist in the target. "
            "F1 scores for these classes will be cast to zeros."
        )


def multiclass_f1_score(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
    average: Optional[str] = "micro",
) -> torch.Tensor:
    """Harmonic mean of precision and recall, multiclass; runs where
    ``input`` is."""
    _f1_score_param_check(num_classes, average)
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    _f1_input_check(input, target, num_classes, "multiclass f1 score")
    num_tp, num_label, num_prediction = _f1_score_update(input, target, num_classes, average)
    if average != "micro":
        _warn_empty_classes(num_label)
    return _f1_score_compute(num_tp, num_label, num_prediction, average)


def binary_f1_score(input, target, *, threshold: float = 0.5) -> torch.Tensor:
    """Binary F1 after thresholding ``input``; runs where ``input`` is."""
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    _binary_f1_input_check(input, target)
    num_tp, num_label, num_prediction = _binary_f1_score_update(input, target, threshold)
    return _f1_score_compute(num_tp, num_label, num_prediction, "micro")
