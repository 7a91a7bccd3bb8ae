"""Binary and one-vs-all multiclass AUROC and AUPRC.

JAX counterpart: ``torcheval_tpu/metrics/functional/classification/auroc.py``.
The curve functions are ``ops/curves.py``'s; the multiclass ones run the
binary function over ``(C, N)`` one-vs-all rows in one batched sort, where
the JAX package ``vmap``s it over the class axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_update_input_check as _auroc_update_input_check,
)
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _multiclass_precision_recall_curve_update_input_check,
)
from torcheval_tpu_torch.ops.curves import (
    binary_auprc_kernel,
    binary_auroc_kernel,
    multiclass_auprc_kernel,
    multiclass_auroc_kernel,
)
from torcheval_tpu_torch.utils.convert import as_tensor

_MC_AVERAGE_OPTIONS = ("macro", "none", None)


def _mc_curve_param_check(num_classes: Optional[int], average: Optional[str]) -> None:
    if average not in _MC_AVERAGE_OPTIONS:
        raise ValueError(
            f"`average` was not in the allowed value of {_MC_AVERAGE_OPTIONS}, "
            f"got {average}."
        )
    if num_classes is None or num_classes < 2:
        raise ValueError(f"num_classes must be at least 2, got {num_classes}.")


def binary_auroc(input, target) -> torch.Tensor:
    """Area under the ROC curve for binary classification; runs where the
    inputs are. 0.5 when the target is all ones or all zeros.

    Args:
        input: scores, shape ``(n_sample,)``.
        target: ground-truth binary labels, shape ``(n_sample,)``.
    """
    input, target = as_tensor(input), as_tensor(target)
    _auroc_update_input_check(input, target)
    return binary_auroc_kernel(input, target)


def binary_auprc(input, target) -> torch.Tensor:
    """Average precision for binary classification (step integration, as
    sklearn's ``average_precision_score``); runs where the inputs are."""
    input, target = as_tensor(input), as_tensor(target)
    _auroc_update_input_check(input, target)
    return binary_auprc_kernel(input, target)


def _mc_average(per_class: torch.Tensor, average: Optional[str]) -> torch.Tensor:
    return per_class.mean() if average == "macro" else per_class


def multiclass_auroc(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
    average: Optional[str] = "macro",
) -> torch.Tensor:
    """One-vs-all multiclass AUROC of ``(n_sample, num_classes)`` scores and
    ``(n_sample,)`` integer labels: the class mean for ``"macro"``, the
    ``(num_classes,)`` vector for ``"none"``/None. A class absent from the
    target, or the only one present, scores 0.5. Runs where ``input`` is."""
    _mc_curve_param_check(num_classes, average)
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    _multiclass_precision_recall_curve_update_input_check(input, target, num_classes)
    return _mc_average(multiclass_auroc_kernel(input, target), average)


def multiclass_auprc(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
    average: Optional[str] = "macro",
) -> torch.Tensor:
    """One-vs-all multiclass average precision; a class absent from the
    target scores 0.0."""
    _mc_curve_param_check(num_classes, average)
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    _multiclass_precision_recall_curve_update_input_check(input, target, num_classes)
    return _mc_average(multiclass_auprc_kernel(input, target), average)
