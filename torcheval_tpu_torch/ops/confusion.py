"""Class counts: the histogram behind per-class accuracy.

JAX counterpart: ``torcheval_tpu/ops/confusion.py`` (``class_counts`` only;
``match_triple_counts`` and the confusion matrix come with the rest of
classification). The JAX package picks one of four lowerings by size and
backend. Here there is one route per case: an unweighted count is the
histogram kernel (``ops/hist.py``: the CUDA kernel on the card, its plain
version on the CPU), and a weighted count is a plain ``index_add_``, which
the JAX package also left to XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.ops.hist import hist


def _as_index(labels: torch.Tensor) -> torch.Tensor:
    # int32 and int64 go to the kernel as they are; anything else is cast
    # the way the JAX package's astype(int32) casts it
    if labels.dtype in (torch.int32, torch.int64):
        return labels
    return labels.to(torch.int64)


def class_counts(
    labels: torch.Tensor,
    num_classes: int,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out[c] = sum(weights[labels == c])`` with shape ``(num_classes,)``.

    ``weights=None`` counts occurrences (int32); otherwise the result has
    the weights' dtype. Labels that are negative or ``>= num_classes``
    contribute nothing."""
    if labels.ndim != 1:
        raise ValueError(f"labels must be 1-D, got shape {tuple(labels.shape)}.")
    labels = _as_index(labels)
    if weights is None:
        return hist(labels, num_classes)
    valid = (labels >= 0) & (labels < num_classes)
    idx = torch.where(valid, labels, num_classes)
    out = torch.zeros(num_classes + 1, dtype=weights.dtype, device=weights.device)
    out.index_add_(0, idx, weights)
    return out[:num_classes]
