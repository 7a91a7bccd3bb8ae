"""Precision (binary and multiclass).

JAX counterpart: ``torcheval_tpu/metrics/functional/classification/precision.py``.
As there: the state is the int32 triple ``(num_tp, num_fp, num_label)``;
the per-class counts come from ``ops/confusion.py::match_triple_counts``
(two histogram launches on the card), with ``num_fp`` the predictions of a
class less its true positives; classes absent from both targets and
predictions leave the macro mean; a class with nothing predicted scores 0.
The binary counts use the JAX package's bitwise ``&`` of the 0/1 prediction
with the int32 target, so a target other than 0 or 1 counts as JAX counts
it.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    _binary_prediction,
)
from torcheval_tpu_torch.ops.confusion import match_triple_counts
from torcheval_tpu_torch.utils.convert import as_tensor

_logger = logging.getLogger(__name__)

# the reference allows the string "None" here
_AVERAGE_OPTIONS = ("micro", "macro", "weighted", "None", None)


def _precision_param_check(num_classes: Optional[int], average: Optional[str]) -> None:
    if average not in _AVERAGE_OPTIONS:
        raise ValueError(
            f"`average` was not in the allowed value of {_AVERAGE_OPTIONS}, got {average}."
        )
    if average != "micro" and (num_classes is None or num_classes <= 0):
        raise ValueError(
            f"num_classes should be a positive number when average={average}."
            f" Got num_classes={num_classes}."
        )


def _precision_input_check(
    input: torch.Tensor, target: torch.Tensor, num_classes: Optional[int]
) -> None:
    if input.shape[0] != target.shape[0]:
        raise ValueError(
            "The `input` and `target` should have the same first dimension, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.ndim != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )
    if not input.ndim == 1 and not (
        input.ndim == 2 and (num_classes is None or input.shape[1] == num_classes)
    ):
        raise ValueError(
            "input should have shape of (num_sample,) or (num_sample, num_classes), "
            f"got {tuple(input.shape)}."
        )


def _binary_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.ndim != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )


def _precision_update(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    average: Optional[str],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if input.ndim == 2:
        input = torch.argmax(input, dim=1)  # first maximum, as jnp.argmax
    input = input.to(torch.int32)
    target = target.to(torch.int32)
    if average == "micro":
        num_tp = (input == target).sum(dtype=torch.int32)
        num_fp = (input != target).sum(dtype=torch.int32)
        return num_tp, num_fp, torch.zeros((), dtype=torch.int32, device=target.device)
    num_tp, num_label, num_pred = match_triple_counts(input, target, num_classes)
    return num_tp, num_pred - num_tp, num_label


def _precision_compute(
    num_tp: torch.Tensor,
    num_fp: torch.Tensor,
    num_label: torch.Tensor,
    average: Optional[str],
) -> torch.Tensor:
    num_tp = num_tp.to(torch.float32)
    num_fp = num_fp.to(torch.float32)
    num_label = num_label.to(torch.float32)
    denom = num_tp + num_fp
    precision = torch.where(denom > 0, num_tp / denom.clamp(min=1.0), 0.0)
    if average == "micro":
        return precision
    mask = (num_label != 0) | (denom != 0)
    if average == "macro":
        return torch.where(mask, precision, 0.0).sum() / mask.sum().clamp(min=1)
    if average == "weighted":
        return (precision * (num_label / num_label.sum().clamp(min=1.0))).sum()
    return precision  # average in (None, "None")


def _binary_precision_update(
    input: torch.Tensor, target: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    pred = _binary_prediction(input, threshold)
    tgt = target.to(torch.int32)
    num_tp = (pred & tgt).sum(dtype=torch.int32)
    num_fp = (pred & (1 - tgt)).sum(dtype=torch.int32)
    return num_tp, num_fp, torch.zeros((), dtype=torch.int32, device=target.device)


def _warn_nan_classes(num_tp: torch.Tensor, num_fp: torch.Tensor, what: str) -> None:
    """Log the classes with nothing predicted and no label. Reads the counts
    on the host, once per compute (the JAX package reads them
    asynchronously)."""
    if num_tp.ndim:
        bad = torch.nonzero((num_tp + num_fp) == 0).flatten()
        if bad.numel():
            _logger.warning(
                f"{bad.tolist()} classes have zero instances in both the predictions "
                f"and the ground truth labels. {what} is still logged as zero."
            )


def multiclass_precision(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
    average: Optional[str] = "micro",
) -> torch.Tensor:
    """TP / (TP + FP), multiclass; runs where ``input`` is."""
    _precision_param_check(num_classes, average)
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    _precision_input_check(input, target, num_classes)
    num_tp, num_fp, num_label = _precision_update(input, target, num_classes, average)
    if average in (None, "None"):
        _warn_nan_classes(num_tp, num_fp, "Precision")
    return _precision_compute(num_tp, num_fp, num_label, average)


def binary_precision(input, target, *, threshold: float = 0.5) -> torch.Tensor:
    """Binary precision after thresholding ``input``; runs where ``input``
    is."""
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    _binary_input_check(input, target)
    num_tp, num_fp, num_label = _binary_precision_update(input, target, threshold)
    return _precision_compute(num_tp, num_fp, num_label, "micro")
