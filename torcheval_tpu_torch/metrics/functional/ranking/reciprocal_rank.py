"""Reciprocal rank.

JAX counterpart:
``torcheval_tpu/metrics/functional/ranking/reciprocal_rank.py``. With a
cutoff ``k`` that the top-k engine takes (``ops/topk.py``: on a CUDA tensor
with more than 1024 labels, the top-k kernel), the rank is counted against
the k largest values only, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional.ranking.hit_rate import (
    _target_range_check,
    _target_score,
)
from torcheval_tpu_torch.ops.topk import _pick_method, topk_values
from torcheval_tpu_torch.utils.convert import as_tensor


def _reciprocal_rank_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
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


def _reciprocal_rank_kernel(
    input: torch.Tensor, target: torch.Tensor, k: Optional[int]
) -> torch.Tensor:
    y_score = _target_score(input, target)
    if (
        k is not None
        and k < input.shape[-1]
        and _pick_method(input.shape[-1], k, input.dtype, "auto", input.device) != "dense"
    ):
        # Only ranks below k count. Against the k largest values the rank is
        # exact when it is below k (every score above the target is among
        # them) and saturates at k otherwise; strict `>` keeps ties from
        # counting against the target, as in the full comparison.
        kv = topk_values(input.to(torch.float32), k)
        rank = torch.sum(kv > y_score.to(torch.float32), dim=-1)
        return torch.where(rank >= k, 0.0, 1.0 / (rank.to(torch.float32) + 1.0))
    rank = torch.sum(input > y_score, dim=-1)
    score = 1.0 / (rank.to(torch.float32) + 1.0)
    if k is not None:
        score = torch.where(rank >= k, 0.0, score)
    return score


def reciprocal_rank(input, target, *, k: Optional[int] = None) -> torch.Tensor:
    """Per-sample ``1 / (rank + 1)`` (float32) of the target class; 0 beyond
    the ``k`` cutoff.

    Args:
        input: scores or logits ``(num_samples, num_classes)``.
        target: class indices ``(num_samples,)``.
        k: optional top-k cutoff.
    """
    input, target = as_tensor(input), as_tensor(target)
    _reciprocal_rank_input_check(input, target)
    _target_range_check(input, target)
    return _reciprocal_rank_kernel(input, target, k)
