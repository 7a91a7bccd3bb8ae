"""Recall (binary and multiclass).

JAX counterpart: ``torcheval_tpu/metrics/functional/classification/recall.py``.
As there: the state is the int32 triple ``(num_tp, num_labels,
num_predictions)`` (the binary metric keeps ``(num_tp, num_true_labels)``),
the per-class counts come from ``ops/confusion.py::match_triple_counts``
(two histogram launches on the card), and a class with no label scores 0
with a warning.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    _binary_prediction,
)
from torcheval_tpu_torch.metrics.functional.classification.precision import (
    _binary_input_check,
)
from torcheval_tpu_torch.ops.confusion import match_triple_counts
from torcheval_tpu_torch.utils.convert import as_tensor

_logger = logging.getLogger(__name__)

_AVERAGE_OPTIONS = ("micro", "macro", "weighted", None)


def _recall_param_check(num_classes: Optional[int], average: Optional[str]) -> None:
    if average not in _AVERAGE_OPTIONS:
        raise ValueError(
            f"`average` was not in the allowed values of {_AVERAGE_OPTIONS}, "
            f"got {average}."
        )
    if average != "micro" and (num_classes is None or num_classes <= 0):
        raise ValueError(
            f"`num_classes` should be a positive number when average={average}, "
            f"got num_classes={num_classes}."
        )


def _recall_input_check(
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


def _recall_update(
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
        n = torch.full((), target.numel(), dtype=torch.int32, device=target.device)
        return num_tp, n, n
    return match_triple_counts(input, target, num_classes)


def _recall_compute(
    num_tp: torch.Tensor,
    num_labels: torch.Tensor,
    num_predictions: torch.Tensor,
    average: Optional[str],
) -> torch.Tensor:
    num_tp = num_tp.to(torch.float32)
    num_labels = num_labels.to(torch.float32)
    num_predictions = num_predictions.to(torch.float32)
    recall = torch.where(num_labels > 0, num_tp / num_labels.clamp(min=1.0), 0.0)
    if average == "micro":
        return recall
    if average == "macro":
        mask = (num_labels != 0) | (num_predictions != 0)
        return torch.where(mask, recall, 0.0).sum() / mask.sum().clamp(min=1)
    if average == "weighted":
        return (recall * (num_labels / num_labels.sum().clamp(min=1.0))).sum()
    return recall  # average is None


def _binary_recall_update(
    input: torch.Tensor, target: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    pred = _binary_prediction(input, threshold)
    tgt = target.to(torch.int32)
    return (pred & tgt).sum(dtype=torch.int32), tgt.sum(dtype=torch.int32)


def _binary_recall_compute(num_tp: torch.Tensor, num_true_labels: torch.Tensor) -> torch.Tensor:
    """The binary recall, with no host read (the warning for a stream with
    no positive label is :func:`_warn_no_positive`)."""
    recall = num_tp.to(torch.float32) / num_true_labels.to(torch.float32).clamp(min=1.0)
    return torch.where(num_true_labels > 0, recall, 0.0)


def _warn_nan_recall(num_labels: torch.Tensor) -> None:
    """Log the classes with no label. Reads the counts on the host, once per
    compute (the JAX package reads them asynchronously)."""
    if num_labels.ndim:
        nan_classes = torch.nonzero(num_labels == 0).flatten()
        if nan_classes.numel():
            _logger.warning(
                f"One or more NaNs identified, as no ground-truth instances of "
                f"{nan_classes.tolist()} have been seen. These have been converted to zero."
            )


def _warn_no_positive(num_true_labels: torch.Tensor) -> None:
    if int(num_true_labels) == 0:
        _logger.warning(
            "One or more NaNs identified, as no ground-truth instances "
            "have been seen. These have been converted to zero."
        )


def multiclass_recall(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
    average: Optional[str] = "micro",
) -> torch.Tensor:
    """TP / (TP + FN), multiclass; runs where ``input`` is."""
    _recall_param_check(num_classes, average)
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    _recall_input_check(input, target, num_classes)
    num_tp, num_labels, num_predictions = _recall_update(input, target, num_classes, average)
    if average != "micro":
        _warn_nan_recall(num_labels)
    return _recall_compute(num_tp, num_labels, num_predictions, average)


def binary_recall(input, target, *, threshold: float = 0.5) -> torch.Tensor:
    """Binary recall after thresholding ``input``; runs where ``input`` is."""
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    _binary_input_check(input, target)
    num_tp, num_true_labels = _binary_recall_update(input, target, threshold)
    _warn_no_positive(num_true_labels)
    return _binary_recall_compute(num_tp, num_true_labels)
