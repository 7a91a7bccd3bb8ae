"""Multiclass and binary accuracy.

JAX counterpart: ``torcheval_tpu/metrics/functional/classification/accuracy.py``
(multiclass and binary parts). As there:

* per-class counts go through ``ops/confusion.py::class_counts``, whose
  unweighted counts are the histogram kernel (``csrc/hist.cu``) on the card;
* counters are int32;
* ``k`` is respected (the reference torcheval hardcodes ``topk(k=2)``).

One change of formulation: in the macro/none branch the JAX package counts
``num_correct`` as a weighted count of the targets with the 0/1 correctness
mask as weights. Here it is the UNWEIGHTED histogram of
``where(mask == 1, target, -1)``: for a 0/1 mask the two are equal, and both
counts of the branch then run on the histogram kernel.

Multilabel and top-k multilabel accuracy wait for the top-k kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.ops.confusion import class_counts
from torcheval_tpu_torch.utils.convert import as_tensor
from torcheval_tpu_torch.utils.numerics import safe_div

_AVERAGE_OPTIONS = ("micro", "macro", "none", None)


def _accuracy_param_check(
    average: Optional[str], num_classes: Optional[int], k: int = 1
) -> None:
    if average not in _AVERAGE_OPTIONS:
        raise ValueError(
            f"`average` was not in the allowed value of {_AVERAGE_OPTIONS}, got {average}."
        )
    if average != "micro" and (num_classes is None or num_classes <= 0):
        raise ValueError(
            f"num_classes should be a positive number when average={average}."
            f" Got num_classes={num_classes}."
        )
    if type(k) is not int:
        raise TypeError(f"Expected `k` to be an integer, but {type(k)} was provided.")
    if k < 1:
        raise ValueError(
            f"Expected `k` to be an integer greater than 0, but {k} was provided."
        )


def _accuracy_update_input_check(
    input: torch.Tensor, target: torch.Tensor, num_classes: Optional[int], k: int
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
    if k > 1 and input.ndim != 2:
        raise ValueError(
            "input should have shape (num_sample, num_classes) for k > 1, "
            f"got shape {tuple(input.shape)}."
        )
    if not input.ndim == 1 and not (
        input.ndim == 2 and (num_classes is None or input.shape[1] == num_classes)
    ):
        raise ValueError(
            "input should have shape of (num_sample,) or (num_sample, num_classes), "
            f"got {tuple(input.shape)}."
        )


def _binary_shape_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.ndim != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )


def _count(n: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32, device=device)


def _multiclass_accuracy_update(
    input: torch.Tensor,
    target: torch.Tensor,
    average: Optional[str],
    num_classes: Optional[int],
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if k == 1:
        if input.ndim == 2:
            input = torch.argmax(input, dim=1)  # first maximum, as jnp.argmax
        mask = input == target
    else:
        y_score = torch.gather(input, 1, target[:, None].to(torch.int64))
        rank = torch.sum(input > y_score, dim=-1)
        mask = rank < k

    if average == "micro":
        return mask.sum(dtype=torch.int32), _count(target.shape[0], target.device)

    target = target if target.dtype in (torch.int32, torch.int64) else target.to(torch.int64)
    num_correct = class_counts(torch.where(mask, target, -1), num_classes)
    num_total = class_counts(target, num_classes)
    return num_correct, num_total


def _accuracy_compute(
    num_correct: torch.Tensor, num_total: torch.Tensor, average: Optional[str]
) -> torch.Tensor:
    num_correct = num_correct.to(torch.float32)
    num_total = num_total.to(torch.float32)
    if average == "macro":
        valid = num_total != 0
        per_class = safe_div(num_correct, num_total)
        return per_class.sum() / torch.clamp(valid.sum(), min=1)
    return num_correct / num_total


def _binary_accuracy_update(
    input: torch.Tensor, target: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    pred = torch.where(input < threshold, 0, 1)
    num_correct = (pred == target).sum(dtype=torch.int32)
    return num_correct, _count(target.shape[0], target.device)


def multiclass_accuracy(
    input,
    target,
    *,
    average: Optional[str] = "micro",
    num_classes: Optional[int] = None,
    k: int = 1,
) -> torch.Tensor:
    """Frequency of predictions matching labels; runs where the inputs are.

    Args:
        input: predicted labels ``(n_sample,)`` or scores
            ``(n_sample, n_class)`` (argmax, or the top-k rank, applied).
        target: ground-truth labels ``(n_sample,)``.
        average: ``"micro"`` (global), ``"macro"`` (mean over the classes
            seen in target), ``"none"``/``None`` (per-class vector).
        num_classes: required unless average is ``"micro"``.
        k: a prediction is correct if the label ranks in the top k scores.
    """
    _accuracy_param_check(average, num_classes, k)
    input, target = as_tensor(input), as_tensor(target)
    _accuracy_update_input_check(input, target, num_classes, k)
    num_correct, num_total = _multiclass_accuracy_update(
        input, target, average, num_classes, k
    )
    return _accuracy_compute(num_correct, num_total, average)


def binary_accuracy(input, target, *, threshold: float = 0.5) -> torch.Tensor:
    """Binary accuracy after thresholding ``input``; runs where the inputs are."""
    input, target = as_tensor(input), as_tensor(target)
    _binary_shape_check(input, target)
    num_correct, num_total = _binary_accuracy_update(input, target, threshold)
    return _accuracy_compute(num_correct, num_total, "micro")
