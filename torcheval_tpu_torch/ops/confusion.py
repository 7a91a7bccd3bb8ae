"""Class counts: the histogram behind per-class accuracy.

JAX counterpart: ``torcheval_tpu/ops/confusion.py`` (``class_counts``,
``match_triple_counts``, ``confusion_matrix_counts`` and
``normalize_confusion_matrix``; ``topk_onehot`` has no caller here). The JAX
package picks one of four lowerings by size and backend. Here there is one
route per case: an unweighted count is the histogram kernel
(``ops/hist.py``: the CUDA kernel on the card, its plain version on the
CPU), and a weighted count is a plain out-of-place ``torch.index_add``,
which the JAX package also left to XLA outside any Pallas kernel, and which
batches under ``torch.func.vmap`` (the in-place ``index_add_`` into a fresh
buffer does not).

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

``match_triple_counts`` takes the JAX package's joint-key form at every
size: two unweighted counts, so on the card two histogram launches and no
``index_add_``. The JAX package keeps a weighted form for batches under its
matmul budget; the integer counts of both forms are equal.

The three counting functions are watched by the recompile watchdog
(``obs/recompile.py``) under their own names, as the JAX package's are
``watched_jit`` entries.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.obs.recompile import watched
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


@watched
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
    return torch.index_add(out, 0, idx, weights)[:num_classes]


@watched
def match_triple_counts(pred: torch.Tensor, target: torch.Tensor, num_classes: int):
    """``(num_tp, num_label, num_pred)`` per class, each ``(num_classes,)``
    int32: the sufficient statistics of F1, precision and recall.

    tp and label fold into one unweighted count over the joint key
    ``2 * target + (pred == target)``: class c's misses land in bin 2c and
    its hits in bin 2c + 1, so ``num_tp = bins[1::2]`` and
    ``num_label = bins[0::2] + num_tp``. Out-of-range targets give keys
    outside ``[0, 2 * num_classes)`` and drop, as do out-of-range
    predictions from ``num_pred``."""
    p, t = _as_index(pred), _as_index(target)
    key = torch.where(t >= 0, 2 * t + (p == t).to(t.dtype), -1)
    bins = class_counts(key, 2 * num_classes)
    num_tp = bins[1::2]
    num_label = bins[0::2] + num_tp
    return num_tp, num_label, class_counts(p, num_classes)


@watched
def confusion_matrix_counts(
    pred: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    *,
    normalize: Optional[str] = None,
) -> torch.Tensor:
    """``out[t, p] = #{i : target[i] == t and pred[i] == p}``, int32
    ``(num_classes, num_classes)``: rows are true classes, columns predicted.

    One unweighted count over the joint key ``t * C + p`` into ``C * C``
    bins (the histogram kernel on the card). A pair with either coordinate
    out of range becomes key -1 and drops, as the JAX package's masked
    scatter and its one-hot matmul drop it. The key stays int32 where both
    labels are int32 and ``C * C`` fits, which halves the bytes the kernel
    reads. ``normalize`` as in :func:`normalize_confusion_matrix`."""
    p, t = _as_index(pred), _as_index(target)
    c = num_classes
    key_dtype = (
        torch.int32
        if p.dtype == t.dtype == torch.int32 and c * c <= torch.iinfo(torch.int32).max
        else torch.int64
    )
    p, t = p.to(key_dtype), t.to(key_dtype)
    valid = (p >= 0) & (p < c) & (t >= 0) & (t < c)
    key = torch.where(valid, t * c + p, -1)
    mat = class_counts(key, c * c).reshape(c, c)
    return normalize_confusion_matrix(mat, normalize)


def normalize_confusion_matrix(mat: torch.Tensor, normalize: Optional[str]) -> torch.Tensor:
    """sklearn's normalisations of a ``(C, C)`` count matrix, in float32:
    None (the counts), ``"all"``, ``"pred"`` (by column) or ``"true"`` (by
    row); an empty row, column or matrix divides by 1."""
    if normalize is None:
        return mat
    m = mat.to(torch.float32)
    if normalize == "all":
        return m / m.sum().clamp(min=1.0)
    if normalize == "pred":
        return m / m.sum(dim=0, keepdim=True).clamp(min=1.0)
    if normalize == "true":
        return m / m.sum(dim=1, keepdim=True).clamp(min=1.0)
    raise ValueError(f"normalize must be None, 'all', 'pred' or 'true', got {normalize!r}.")
