"""Class counts: the histogram behind per-class accuracy.

JAX counterpart: ``torcheval_tpu/ops/confusion.py`` (``class_counts`` only;
``match_triple_counts`` and the confusion matrix come with the rest of
classification). The JAX package picks one of four lowerings by size and
backend. Here there is one route per case: an unweighted count is the
histogram kernel (``ops/hist.py``: the CUDA kernel on the card, its plain
version on the CPU), and a weighted count is a plain ``index_add_``, which
the JAX package also left to XLA outside any Pallas kernel.

The unweighted count has a ``torch.func.vmap`` rule, so that the sliced
collection can run per-class folds per sample, as the JAX package does with
``jax.vmap``: a batch of B label vectors becomes one segment sum of int32
ones (``ops/scatter.py``, the segment-sum kernel on the card) by the
combined index ``b * num_classes + label`` over ``B * num_classes``
segments. The histogram kernel tiles its bins through shared memory and
reads the whole stream once per tile, so its cost would grow with B times
the bin count; the segment sum's global atomics do work in proportion to
the stream for any number of segments. No kernel wrapper ever sees a
batched tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.ops.hist import hist
from torcheval_tpu_torch.ops.scatter import segment_sum


def _as_index(labels: torch.Tensor) -> torch.Tensor:
    # int32 and int64 go to the kernel as they are; anything else is cast
    # the way the JAX package's astype(int32) casts it
    if labels.dtype in (torch.int32, torch.int64):
        return labels
    return labels.to(torch.int64)


class _ClassCounts(torch.autograd.Function):
    """The unweighted count as a function with a vmap rule (no gradient:
    counts are integers)."""

    @staticmethod
    def forward(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
        return hist(labels, num_classes)

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        pass

    @staticmethod
    def vmap(info, in_dims, labels: torch.Tensor, num_classes: int):
        labels = labels.movedim(in_dims[0], 0)
        b = labels.shape[0]
        valid = (labels >= 0) & (labels < num_classes)
        offset = torch.arange(b, dtype=torch.int64, device=labels.device)[:, None] * num_classes
        combined = torch.where(valid, labels.to(torch.int64) + offset, -1).reshape(-1)
        ones = torch.ones(combined.shape[0], dtype=torch.int32, device=labels.device)
        return segment_sum(ones, combined, b * num_classes).reshape(b, num_classes), 0


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
        return _ClassCounts.apply(labels, num_classes)
    valid = (labels >= 0) & (labels < num_classes)
    idx = torch.where(valid, labels, num_classes)
    out = torch.zeros(num_classes + 1, dtype=weights.dtype, device=weights.device)
    out.index_add_(0, idx, weights)
    return out[:num_classes]
