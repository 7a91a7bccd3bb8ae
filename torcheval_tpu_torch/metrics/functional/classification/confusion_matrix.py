"""Confusion matrix (multiclass and binary).

JAX counterpart:
``torcheval_tpu/metrics/functional/classification/confusion_matrix.py``.
Rows are true classes, columns predicted classes. The counts are one
histogram over the joint key ``target * C + pred``
(``ops/confusion.py::confusion_matrix_counts``: the histogram kernel on the
card, over ``C * C`` bins).
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.ops.confusion import confusion_matrix_counts
from torcheval_tpu_torch.utils.convert import as_tensor

_NORMALIZE_OPTIONS = (None, "all", "pred", "true")


def _confusion_matrix_param_check(num_classes: Optional[int], normalize: Optional[str]) -> None:
    if num_classes is None or num_classes < 2:
        raise ValueError(f"num_classes must be at least 2, got {num_classes}.")
    if normalize not in _NORMALIZE_OPTIONS:
        raise ValueError(f"normalize must be one of {_NORMALIZE_OPTIONS}, got {normalize}.")


def _confusion_matrix_input_check(
    input: torch.Tensor, target: torch.Tensor, num_classes: Optional[int] = None
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


def _binary_prediction(input: torch.Tensor, threshold: float) -> torch.Tensor:
    """0 below ``threshold``, else 1 (NaN included, as in JAX)."""
    return torch.where(input < threshold, 0, 1).to(torch.int32)


def multiclass_confusion_matrix(
    input,
    target,
    num_classes: int,
    *,
    normalize: Optional[str] = None,
) -> torch.Tensor:
    """``(num_classes, num_classes)`` confusion counts (int32, or float32
    when normalised); ``input`` is labels ``(n,)`` or scores ``(n, c)``
    (argmax applied). Runs where ``input`` is."""
    _confusion_matrix_param_check(num_classes, normalize)
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    _confusion_matrix_input_check(input, target, num_classes)
    if input.ndim == 2:
        input = torch.argmax(input, dim=1)  # first maximum, as jnp.argmax
    return confusion_matrix_counts(input, target, num_classes, normalize=normalize)


def binary_confusion_matrix(
    input,
    target,
    *,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
) -> torch.Tensor:
    """2x2 confusion counts after thresholding the scores at ``threshold``."""
    if normalize not in _NORMALIZE_OPTIONS:
        raise ValueError(f"normalize must be one of {_NORMALIZE_OPTIONS}, got {normalize}.")
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    _confusion_matrix_input_check(input, target)
    return confusion_matrix_counts(
        _binary_prediction(input, threshold), target, 2, normalize=normalize
    )
