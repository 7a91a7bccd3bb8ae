"""Frequency threshold indicator.

JAX counterpart: ``torcheval_tpu/metrics/functional/ranking/frequency.py``.
"""

from __future__ import annotations

import torch

from torcheval_tpu_torch.utils.convert import as_tensor


def _frequency_input_check(input: torch.Tensor, k: float) -> None:
    if input.ndim != 1:
        raise ValueError(
            f"input should be a one-dimensional tensor, got shape {tuple(input.shape)}."
        )
    if k < 0:
        raise ValueError(f"k should not be negative, got {k}.")


def frequency_at_k(input, k: float) -> torch.Tensor:
    """Float32 indicator, 1.0 where ``input < k`` (frequency below the
    threshold).

    Args:
        input: 1-D frequencies.
        k: non-negative threshold.
    """
    input = as_tensor(input)
    _frequency_input_check(input, k)
    return (input < k).to(torch.float32)
