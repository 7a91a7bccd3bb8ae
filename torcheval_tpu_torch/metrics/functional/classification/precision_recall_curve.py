"""Exact precision-recall curves (binary and one-vs-all multiclass).

JAX counterpart:
``torcheval_tpu/metrics/functional/classification/precision_recall_curve.py``.
A curve has one point per distinct threshold, a length that depends on the
data. As in JAX, the device computes full-length points and a "last of its
tie group" mask in one sort pass (``ops/curves.py::prc_points_kernel``), and
:func:`_trim_curve` selects, flips and closes the curve on the host: the
host read is inherent in a result whose length depends on the data. The
results come back on the input's device. The streaming form with fixed
thresholds is ``binned_precision_recall_curve.py``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.ops.curves import (
    class_onehot_rows,
    multiclass_prc_points_kernel,
    prc_points_kernel,
)
from torcheval_tpu_torch.utils.convert import as_tensor


def _binary_precision_recall_curve_update_input_check(
    input: torch.Tensor, target: torch.Tensor
) -> None:
    if input.ndim != 1:
        raise ValueError(
            f"input should be a one-dimensional tensor, got shape {tuple(input.shape)}."
        )
    if target.ndim != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same shape, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )


def _multiclass_precision_recall_curve_update_input_check(
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
    if not (input.ndim == 2 and (num_classes is None or input.shape[1] == num_classes)):
        raise ValueError(
            "input should have shape of (num_sample, num_classes), "
            f"got {tuple(input.shape)} and num_classes={num_classes}."
        )


def _trim_curve(
    thresholds: np.ndarray,
    precision: np.ndarray,
    recall: np.ndarray,
    last: np.ndarray,
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """On the host: select the tie-group ends, flip them to ascending
    thresholds, and append the (precision 1, recall 0) origin point."""
    p = precision[last][::-1]
    r = recall[last][::-1]
    t = thresholds[last][::-1]
    p = np.concatenate([p, np.ones(1, dtype=p.dtype)])
    r = np.concatenate([r, np.zeros(1, dtype=r.dtype)])
    # An explicit copy: numpy calls a one-element reversed view contiguous
    # whatever its stride, so ascontiguousarray would hand torch the
    # negative stride it refuses.
    return tuple(torch.from_numpy(a.copy()).to(device) for a in (p, r, t))


def binary_precision_recall_curve(input, target) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Precision-recall pairs and thresholds for binary classification.

    Returns ``(precision, recall, thresholds)`` with shapes ``(k+1,)``,
    ``(k+1,)`` and ``(k,)`` for ``k`` distinct thresholds; recall is 1.0
    everywhere when the target has no positives."""
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    _binary_precision_recall_curve_update_input_check(input, target)
    s, p, r, last = (a.cpu().numpy() for a in prc_points_kernel(input, target))
    return _trim_curve(s, p, r, last, input.device)


def multiclass_precision_recall_curve(
    input, target, *, num_classes: Optional[int] = None
) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """One-vs-all precision-recall curves: ``(precision, recall,
    thresholds)``, each a list with one curve per class. ``num_classes``
    defaults to ``input.shape[1]``."""
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    if num_classes is None and input.ndim == 2:
        num_classes = input.shape[1]
    _multiclass_precision_recall_curve_update_input_check(input, target, num_classes)
    onehot = class_onehot_rows(target, num_classes)
    s, p, r, last = (
        a.cpu().numpy() for a in multiclass_prc_points_kernel(input.T, onehot)
    )
    curves = [_trim_curve(s[c], p[c], r[c], last[c], input.device) for c in range(num_classes)]
    return tuple(list(x) for x in zip(*curves)) if curves else ([], [], [])
