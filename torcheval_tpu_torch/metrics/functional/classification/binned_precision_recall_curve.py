"""Binned precision-recall curves: counts at fixed thresholds.

JAX counterpart:
``torcheval_tpu/metrics/functional/classification/binned_precision_recall_curve.py``.
The state is int32 counters of shape ``(T,)`` (binary) or ``(T, C)``
(multiclass), one row per threshold, merged by a sum.

The JAX package compares every score with every threshold, a ``(T, N)`` or
``(T, N, C)`` array that XLA fuses into its reduction. Eager PyTorch would
build it (819 MB of bools at T = 100, N = 8192, C = 1000), so the port
counts buckets instead:

* each score gets the bucket ``b = searchsorted(thresholds, score,
  right=True)``, the number of thresholds at or below it, so that
  ``score >= thresholds[i]`` exactly when ``b > i`` (repeated thresholds
  and -0.0 against 0.0 included). Scores compare in float32, as JAX's do
  with x64 off; bfloat16 and float16 scores widen exactly. A NaN score,
  which the comparison counts at no threshold, takes bucket 0
  (``searchsorted`` would put it last);
* the count at threshold ``i`` is the sum of the buckets above ``i``, a
  reverse cumulative sum of per-bucket counts;
* multiclass: one unweighted count (the histogram kernel on the card) over
  the key ``(c * (T + 1) + b) * 2 + (target == c)`` into ``2 * C * (T + 1)``
  bins;
* binary: JAX multiplies the comparison by the int32 target, so a target
  other than 0 or 1 is a weight (a float target truncated first). The
  positive count is the weighted ``class_counts`` of the buckets by that
  target, the total the unweighted one.

Under ``torch.func.vmap`` (a window's stacked fold) the unweighted count
becomes one segment sum over ``B * bins`` segments (the class counts' vmap
rule) and the weighted one an out-of-place ``index_add``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_update_input_check,
    _multiclass_precision_recall_curve_update_input_check,
)
from torcheval_tpu_torch.ops.confusion import class_counts
from torcheval_tpu_torch.utils.convert import as_tensor

ThresholdSpec = Union[int, Sequence[float], torch.Tensor]


def _linspace01(n: int) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in float32, bit for bit: ``iota`` times the
    float32 reciprocal of ``n - 1``, as XLA computes JAX's ``iota / (n - 1)``,
    with the endpoint 1.0 appended (``torch.linspace`` rounds differently)."""
    if n <= 1:
        return torch.zeros(n, dtype=torch.float32)
    step = torch.arange(n - 1, dtype=torch.float32) * (1 / torch.tensor(n - 1, dtype=torch.float32))
    return torch.cat([step, torch.ones(1)])


def _create_threshold_tensor(threshold: ThresholdSpec) -> torch.Tensor:
    """The thresholds as float32 (the type JAX holds them in with x64 off),
    where a given tensor is; an int ``n`` is ``n`` even steps over [0, 1]."""
    if isinstance(threshold, int):
        return _linspace01(threshold)
    return as_tensor(threshold, dtype=torch.float32)


def _binned_precision_recall_curve_param_check(threshold: torch.Tensor) -> None:
    if bool((torch.diff(threshold) < 0.0).any()):
        raise ValueError("The `threshold` should be a sorted array.")
    if bool(((threshold < 0.0) | (threshold > 1.0)).any()):
        raise ValueError("The values in `threshold` should be in the range of [0, 1].")


def _buckets(input: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """int32 bucket of each score: the thresholds at or below it, 0 for NaN."""
    x = input.to(torch.float32).contiguous()
    b = torch.searchsorted(
        threshold.to(x.device, non_blocking=True), x, right=True, out_int32=True
    )
    return torch.where(torch.isnan(x), 0, b)


def _above(counts: torch.Tensor) -> torch.Tensor:
    """``out[..., i] = sum(counts[..., i + 1:])`` over ``T + 1`` buckets:
    the count of scores at or above threshold ``i``, int32."""
    return torch.cumsum(counts[..., 1:].flip(-1), -1, dtype=torch.int32).flip(-1)


def _binary_binned_update(
    input: torch.Tensor, target: torch.Tensor, threshold: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    n_buckets = threshold.shape[0] + 1
    b = _buckets(input, threshold)
    positives = class_counts(b, n_buckets, weights=target.to(torch.int32))
    num_tp = _above(positives)
    num_fp = _above(class_counts(b, n_buckets)) - num_tp
    num_fn = positives.sum(dtype=torch.int32) - num_tp
    return num_tp, num_fp, num_fn


def _binary_binned_compute(
    num_tp: torch.Tensor, num_fp: torch.Tensor, num_fn: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    tp = num_tp.to(torch.float32)
    fp = num_fp.to(torch.float32)
    fn = num_fn.to(torch.float32)
    # precision 1.0 where nothing is predicted positive, recall NaN where
    # nothing is labelled positive (the reference's nan_to_num)
    precision = torch.where(tp + fp > 0, tp / (tp + fp).clamp(min=1.0), 1.0)
    recall = torch.where(tp + fn > 0, tp / (tp + fn).clamp(min=1.0), torch.nan)
    ones = precision.new_ones((1,) + precision.shape[1:])
    precision = torch.cat([precision, ones])
    recall = torch.cat([recall, torch.zeros_like(ones)])
    return precision, recall


def binary_binned_precision_recall_curve(
    input, target, *, threshold: ThresholdSpec = 100
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Precision-recall curve at fixed thresholds (binary): ``(precision,
    recall, thresholds)`` of shapes ``(T+1,)``, ``(T+1,)`` and ``(T,)``.

    ``threshold`` is a count (even steps over [0, 1]), a list or a tensor of
    sorted thresholds in [0, 1]. Runs where ``input`` is."""
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    threshold = _create_threshold_tensor(threshold)
    _binned_precision_recall_curve_param_check(threshold)
    _binary_precision_recall_curve_update_input_check(input, target)
    threshold = threshold.to(input.device)
    num_tp, num_fp, num_fn = _binary_binned_update(input, target, threshold)
    precision, recall = _binary_binned_compute(num_tp, num_fp, num_fn)
    return precision, recall, threshold


def _multiclass_binned_update(
    input: torch.Tensor, target: torch.Tensor, threshold: torch.Tensor, num_classes: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    n_buckets = threshold.shape[0] + 1
    classes = torch.arange(num_classes, dtype=torch.int32, device=input.device)
    hit = (target[:, None] == classes).to(torch.int32)  # (N, C)
    key = (classes * n_buckets + _buckets(input, threshold)) * 2 + hit
    bins = class_counts(key.reshape(-1), 2 * num_classes * n_buckets)
    bins = bins.reshape(num_classes, n_buckets, 2)
    positives = bins[..., 1]  # (C, T + 1)
    num_tp = _above(positives).T  # (T, C)
    num_fp = _above(bins.sum(-1, dtype=torch.int32)).T - num_tp
    num_fn = positives.sum(-1, dtype=torch.int32)[None, :] - num_tp
    return num_tp, num_fp, num_fn


_multiclass_binned_compute = _binary_binned_compute


def multiclass_binned_precision_recall_curve(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
    threshold: ThresholdSpec = 100,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """One-vs-all precision-recall curves at fixed thresholds:
    ``(precision, recall, thresholds)``, precision and recall a list with
    one ``(T+1,)`` curve per class. ``num_classes`` defaults to
    ``input.shape[1]``."""
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    threshold = _create_threshold_tensor(threshold)
    _binned_precision_recall_curve_param_check(threshold)
    if num_classes is None and input.ndim == 2:
        num_classes = input.shape[1]
    _multiclass_precision_recall_curve_update_input_check(input, target, num_classes)
    threshold = threshold.to(input.device)
    num_tp, num_fp, num_fn = _multiclass_binned_update(input, target, threshold, num_classes)
    precision, recall = _multiclass_binned_compute(num_tp, num_fp, num_fn)
    return list(precision.T), list(recall.T), threshold
