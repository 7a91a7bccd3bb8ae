"""Hit rate @ k.

JAX counterpart: ``torcheval_tpu/metrics/functional/ranking/hit_rate.py``.
The rank test gathers only the target's score and counts the scores that
strictly exceed it: one compare and one row sum over the score matrix, with
no top-k.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.utils.convert import as_tensor


def _target_range_check(input: torch.Tensor, target: torch.Tensor) -> None:
    """Reject target indices outside ``[0, num_classes)``, as torch's
    ``gather`` would. The check reads the target's range on the host."""
    if target.numel() == 0:
        return
    lo, hi = int(target.min()), int(target.max())
    if lo < 0 or hi >= input.shape[-1]:
        raise ValueError(
            f"target indices must be in [0, {input.shape[-1]}), got values in [{lo}, {hi}]."
        )


def _hit_rate_input_check(
    input: torch.Tensor, target: torch.Tensor, k: Optional[int] = None
) -> None:
    if target.ndim != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )
    if input.ndim != 2:
        raise ValueError(
            f"input should be a two-dimensional tensor, got shape {tuple(input.shape)}."
        )
    if input.shape[0] != target.shape[0]:
        raise ValueError(
            "`input` and `target` should have the same minibatch dimension, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}, respectively."
        )
    if k is not None and k <= 0:
        raise ValueError(f"k should be None or positive, got {k}.")


def _target_score(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Each row's score at its target, ``(N, 1)``."""
    return torch.gather(input, 1, target.to(torch.int64)[:, None])


def hit_rate(input, target, *, k: Optional[int] = None) -> torch.Tensor:
    """Per-sample indicator (float32) of the target class ranking in the top
    ``k``: fewer than ``k`` scores strictly above the target's.

    Args:
        input: scores or logits ``(num_samples, num_classes)``.
        target: class indices ``(num_samples,)``.
        k: top-k cutoff; ``None`` (or ``k >= num_classes``) hits everything.
    """
    input, target = as_tensor(input), as_tensor(target)
    _hit_rate_input_check(input, target, k)
    _target_range_check(input, target)
    if k is None or k >= input.shape[-1]:
        return torch.ones(target.shape[0], dtype=torch.float32, device=input.device)
    rank = torch.sum(input > _target_score(input, target), dim=-1)
    return (rank < k).to(torch.float32)
