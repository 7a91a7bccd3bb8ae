"""Retrieval metrics @ k (NDCG, MAP, Recall, HitRate) over a
``(num_samples, num_labels)`` relevance matrix.

JAX counterpart: ``torcheval_tpu/metrics/functional/ranking/retrieval.py``.
Every function ranks the label axis through the top-k engine
(``ops/topk.py``: on a CUDA tensor with more than 1024 labels and
``k <= 128``, the top-k kernel), never a full-width sort, and gathers the
relevance at the selected indices. The ideal ranking of NDCG is the top-k of
the relevance row itself, through the same engine.

Per-sample semantics, as in the JAX package:

* a row is valid when it has a relevant label (``target > 0``; for NDCG a
  positive ideal DCG). Invalid rows give NaN, and the class metrics leave
  them out of the mean;
* ``recall_at_k``: ``|top-k & relevant| / |relevant|``;
* ``map_at_k``: ``(1 / min(|relevant|, k)) * sum_j rel_j * precision@j``;
* ``ndcg_at_k``: linear graded gains, ``1 / log2(rank + 2)`` discounts;
* ``retrieval_hit_rate``: 1.0 if any relevant label ranks in the top k.

Ranks follow ``jax.lax.top_k``'s order (values descending, ties by lowest
index), so every result is deterministic on every lowering. The JAX
package's ``label_mesh=`` (the label-sharded engine) comes with the
distributed slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.ops.topk import topk, topk_values
from torcheval_tpu_torch.utils.convert import as_tensor


def _retrieval_input_check(
    input: torch.Tensor, target: torch.Tensor, k: Optional[int]
) -> None:
    if input.ndim != 2:
        raise ValueError(
            f"input should be a two-dimensional tensor, got shape {tuple(input.shape)}."
        )
    if target.shape != input.shape:
        raise ValueError(
            "`input` and `target` should have the same (num_samples, "
            f"num_labels) shape, got {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if k is not None and (type(k) is not int or k <= 0):
        raise ValueError(f"k should be None or a positive int, got {k!r}.")


def _topk_rel(input, target, k: int, topk_method: str) -> torch.Tensor:
    """Relevance at the top-k score positions, ``(N, k)``, in rank order."""
    idx = topk(input, k, method=topk_method)[1]
    return torch.gather(target.to(torch.float32), 1, idx)


def _num_relevant(target: torch.Tensor) -> torch.Tensor:
    return torch.sum((target > 0).to(torch.float32), dim=1)


def _resolve_k(k: Optional[int], num_labels: int) -> int:
    return num_labels if k is None else min(k, num_labels)


def _valid_or_nan(valid: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, value, torch.nan)


def _recall_kernel(input, target, k, topk_method):
    k = _resolve_k(k, input.shape[1])
    hits = torch.sum((_topk_rel(input, target, k, topk_method) > 0).to(torch.float32), dim=1)
    m = _num_relevant(target)
    return _valid_or_nan(m > 0, hits / torch.clamp(m, min=1.0))


def _map_kernel(input, target, k, topk_method):
    k = _resolve_k(k, input.shape[1])
    rel = (_topk_rel(input, target, k, topk_method) > 0).to(torch.float32)
    ranks = torch.arange(1, k + 1, dtype=torch.float32, device=input.device)
    prec = torch.cumsum(rel, dim=1) / ranks
    m = _num_relevant(target)
    denom = torch.clamp(torch.clamp(m, max=float(k)), min=1.0)
    return _valid_or_nan(m > 0, torch.sum(rel * prec, dim=1) / denom)


def _ndcg_kernel(input, target, k, topk_method):
    k = _resolve_k(k, input.shape[1])
    disc = 1.0 / torch.log2(torch.arange(k, dtype=torch.float32, device=input.device) + 2.0)
    dcg = torch.sum(_topk_rel(input, target, k, topk_method) * disc, dim=1)
    ideal = topk_values(target.to(torch.float32), k, method=topk_method)
    # rows with fewer than k relevant labels: the tail holds the row's own
    # non-positive relevance, which adds nothing
    idcg = torch.sum(torch.clamp(ideal, min=0.0) * disc, dim=1)
    positive = idcg > 0
    return _valid_or_nan(positive, dcg / torch.where(positive, idcg, 1.0))


def _hit_rate_kernel(input, target, k, topk_method):
    k = _resolve_k(k, input.shape[1])
    hit = torch.amax((_topk_rel(input, target, k, topk_method) > 0).to(torch.float32), dim=1)
    return _valid_or_nan(_num_relevant(target) > 0, hit)


def _entry(kernel, input, target, k, topk_method):
    input, target = as_tensor(input), as_tensor(target)
    _retrieval_input_check(input, target, k)
    return kernel(input, target, k, topk_method)


def recall_at_k(
    input, target, *, k: Optional[int] = None, topk_method: str = "auto"
) -> torch.Tensor:
    """Per-sample Recall@k: relevant labels ranked in the top ``k`` over the
    row's count of relevant labels (NaN for a row with none).

    Args:
        input: scores or logits ``(num_samples, num_labels)``.
        target: relevance ``(num_samples, num_labels)`` (``> 0`` is relevant).
        k: cutoff; ``None`` (or ``k >= num_labels``) ranks every label.
        topk_method: the lowering of ``ops/topk.py``.
    """
    return _entry(_recall_kernel, input, target, k, topk_method)


def map_at_k(
    input, target, *, k: Optional[int] = None, topk_method: str = "auto"
) -> torch.Tensor:
    """Per-sample MAP@k (truncated average precision): ``(1 / min(m, k)) *
    sum_j rel_j * precision@j`` with ``m`` the row's relevant count (NaN for
    a row with none). Arguments as :func:`recall_at_k`."""
    return _entry(_map_kernel, input, target, k, topk_method)


def ndcg_at_k(
    input, target, *, k: Optional[int] = None, topk_method: str = "auto"
) -> torch.Tensor:
    """Per-sample NDCG@k: linear graded gains, ``1 / log2(rank + 2)``
    discounts, normalised by the row's ideal DCG@k (NaN where that is
    zero). Arguments as :func:`recall_at_k`."""
    return _entry(_ndcg_kernel, input, target, k, topk_method)


def retrieval_hit_rate(
    input, target, *, k: Optional[int] = None, topk_method: str = "auto"
) -> torch.Tensor:
    """Per-sample HitRate@k over a relevance matrix: 1.0 if any relevant
    label ranks in the top ``k`` (NaN for a row with none). Arguments as
    :func:`recall_at_k`."""
    return _entry(_hit_rate_kernel, input, target, k, topk_method)
