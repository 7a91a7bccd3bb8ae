"""Binary AUROC and AUPRC.

JAX counterpart: ``torcheval_tpu/metrics/functional/classification/auroc.py``
(binary part). The input check is copied from the JAX package's
``precision_recall_curve.py`` (``_binary_precision_recall_curve_update_input_check``).
The one-vs-all multiclass curves come with the rest of classification.
"""

from __future__ import annotations

import torch

from torcheval_tpu_torch.ops.curves import binary_auprc_kernel, binary_auroc_kernel
from torcheval_tpu_torch.utils.convert import as_tensor


def _auroc_update_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
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
