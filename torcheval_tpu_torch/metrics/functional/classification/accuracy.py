"""Accuracy family: multiclass, binary, multilabel and top-k multilabel.

JAX counterpart: ``torcheval_tpu/metrics/functional/classification/accuracy.py``.
As there:

* per-class counts go through ``ops/confusion.py::class_counts``, whose
  unweighted counts are the histogram kernel (``csrc/hist.cu``) on the card;
* counters are int32;
* ``k`` is respected (the reference torcheval hardcodes ``topk(k=2)``);
* top-k multilabel accuracy counts from set statistics over the top-k
  indices (``ops/topk.py``, the top-k kernel on the card), never from an
  (N, C) one-hot of the prediction set.

One change of formulation: in the macro/none branch the JAX package counts
``num_correct`` as a weighted count of the targets with the 0/1 correctness
mask as weights. Here it is the UNWEIGHTED histogram of
``where(mask == 1, target, -1)``: for a 0/1 mask the two are equal, and both
counts of the branch then run on the histogram kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.ops.confusion import class_counts
from torcheval_tpu_torch.ops.topk import _METHODS as _TOPK_METHODS
from torcheval_tpu_torch.ops.topk import topk_indices
from torcheval_tpu_torch.utils.convert import as_tensor
from torcheval_tpu_torch.utils.numerics import safe_div

_AVERAGE_OPTIONS = ("micro", "macro", "none", None)
_CRITERIA_OPTIONS = ("exact_match", "hamming", "overlap", "contain", "belong")


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
    """An int32 scalar on ``device``, filled there: ``torch.tensor`` would
    copy it from the host and wait for the device to drain."""
    return torch.full((), n, dtype=torch.int32, device=device)


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


def _multilabel_update(
    input_label: torch.Tensor, target: torch.Tensor, criteria: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    n = _count(target.shape[0], target.device)
    if criteria == "exact_match":
        return torch.all(input_label == target, dim=1).sum(dtype=torch.int32), n
    if criteria == "hamming":
        return (input_label == target).sum(dtype=torch.int32), _count(
            target.numel(), target.device
        )
    if criteria == "overlap":
        hit = torch.any((input_label == target) & (input_label == 1), dim=1)
        both_empty = torch.all((input_label == 0) & (target == 0), dim=1)
        return hit.sum(dtype=torch.int32) + both_empty.sum(dtype=torch.int32), n
    if criteria == "contain":
        return torch.all(input_label - target >= 0, dim=1).sum(dtype=torch.int32), n
    # belong
    return torch.all(input_label - target <= 0, dim=1).sum(dtype=torch.int32), n


def _multilabel_accuracy_param_check(criteria: str) -> None:
    if criteria not in _CRITERIA_OPTIONS:
        raise ValueError(
            f"`criteria` was not in the allowed value of {_CRITERIA_OPTIONS}, got {criteria}."
        )


def _multilabel_shape_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )


def _topk_multilabel_accuracy_param_check(criteria: str, k: int) -> None:
    _multilabel_accuracy_param_check(criteria)
    if type(k) is not int:
        raise TypeError(f"Expected `k` to be an integer, but {type(k)} was provided.")
    if k <= 1:
        raise ValueError(
            f"Expected `k` to be an integer greater than 1, but {k} was provided. "
            "For k = 1, please use multilabel_accuracy."
        )


def _topk_method_check(topk_method: str) -> None:
    if topk_method not in _TOPK_METHODS:
        raise ValueError(
            f"topk_method must be one of {_TOPK_METHODS}, got {topk_method!r}."
        )


def _multilabel_accuracy_update(
    input: torch.Tensor, target: torch.Tensor, threshold: float, criteria: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    _multilabel_shape_check(input, target)
    input_label = torch.where(input < threshold, 0, 1)
    return _multilabel_update(input_label, target, criteria)


def _topk_multilabel_stats(
    input: torch.Tensor,
    target: torch.Tensor,
    criteria: str,
    k: int,
    topk_method: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All five criteria from set statistics. With ``P`` the top-k set and
    ``T`` the positive labels, ``inter = |P & T|`` gathers the targets at
    the top-k indices; then exact_match is inter == k == |T|, hamming
    agreement is C - (k + |T| - 2 inter), overlap is inter > 0, contain
    (T in P) is inter == |T| and belong (P in T) is inter == k."""
    idx = topk_indices(input, k, method=topk_method)
    # the (N, C) positives as a bool mask: one byte a label, where an int32
    # copy would move four
    inter = (torch.gather(target, 1, idx) != 0).sum(dim=1, dtype=torch.int32)
    t_count = (target != 0).sum(dim=1, dtype=torch.int32)
    n = _count(target.shape[0], target.device)
    if criteria == "exact_match":
        correct = ((inter == k) & (t_count == k)).sum(dtype=torch.int32)
    elif criteria == "hamming":
        agree = target.shape[1] - (k + t_count - 2 * inter)
        return agree.sum(dtype=torch.int32), _count(target.numel(), target.device)
    elif criteria == "overlap":
        correct = (inter > 0).sum(dtype=torch.int32)
    elif criteria == "contain":
        correct = (inter == t_count).sum(dtype=torch.int32)
    else:  # belong
        correct = (inter == k).sum(dtype=torch.int32)
    return correct, n


def _topk_multilabel_accuracy_update(
    input: torch.Tensor,
    target: torch.Tensor,
    criteria: str,
    k: int,
    topk_method: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    _multilabel_shape_check(input, target)
    if input.ndim != 2:
        raise ValueError(
            "input should have shape (num_sample, num_classes) for k > 1, "
            f"got shape {tuple(input.shape)}."
        )
    return _topk_multilabel_stats(input, target, criteria, k, topk_method)


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


def multilabel_accuracy(
    input, target, *, threshold: float = 0.5, criteria: str = "exact_match"
) -> torch.Tensor:
    """Multilabel accuracy under one of five criteria (exact_match, hamming,
    overlap, contain, belong) after thresholding ``input``."""
    _multilabel_accuracy_param_check(criteria)
    input, target = as_tensor(input), as_tensor(target)
    num_correct, num_total = _multilabel_accuracy_update(input, target, threshold, criteria)
    return _accuracy_compute(num_correct, num_total, "micro")


def topk_multilabel_accuracy(
    input,
    target,
    *,
    criteria: str = "exact_match",
    k: int = 2,
    topk_method: str = "auto",
) -> torch.Tensor:
    """Multilabel accuracy where the prediction set is the top-k scores.

    ``topk_method`` forces a lowering of ``ops/topk.py`` (``"dense"``,
    ``"prune"``, ``"kernel"``); ``"auto"`` picks by size and device, with
    the same result."""
    _topk_multilabel_accuracy_param_check(criteria, k)
    input, target = as_tensor(input), as_tensor(target)
    num_correct, num_total = _topk_multilabel_accuracy_update(
        input, target, criteria, k, topk_method
    )
    return _accuracy_compute(num_correct, num_total, "micro")
