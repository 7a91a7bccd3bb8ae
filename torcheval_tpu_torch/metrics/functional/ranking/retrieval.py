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
index), so every result is deterministic on every lowering.

``label_mesh=(mesh, label_dim)`` (a ``DeviceMesh`` and the name of its
label dim; a third entry, the data dim's name, is checked and otherwise
unused) ranks a label axis split over the ranks of that dim: each rank
passes its label tiles of ``input`` and ``target``
(``parallel.label_tile``), and the top-k runs through
``ops/topk.py::sharded_label_topk`` with the relevance gathered inside each
rank's tile, the ideal ranking likewise, and the relevant count as the
local count plus one ``all_reduce(SUM)``. Every rank of the label group
gets the per-sample values of its rows. Each call runs collectives over
the group, so every rank of it calls together. ``k=None`` there costs one
more ``all_reduce`` (for the global label count).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.ops.topk import sharded_label_topk, topk, topk_values
from torcheval_tpu_torch.utils import dist as _dist
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


def _check_label_mesh(label_mesh) -> None:
    """Validate ``label_mesh`` when it is given: ``(mesh, label_dim)`` or
    ``(mesh, label_dim, data_dim)``, names that the mesh has, so that a
    wrong name fails at construction, not at the first fold."""
    if label_mesh is None:
        return
    if (
        not isinstance(label_mesh, tuple)
        or len(label_mesh) not in (2, 3)
        or not isinstance(label_mesh[1], str)
    ):
        raise ValueError(
            "label_mesh must be a (DeviceMesh, label_dim_name) or (DeviceMesh, "
            f"label_dim_name, data_dim_name) tuple, got {label_mesh!r}."
        )
    mesh, label_axis = _label_mesh_parts(label_mesh)
    _dist.mesh_axis(mesh, label_axis)
    if len(label_mesh) == 3 and label_mesh[2] is not None:
        data = label_mesh[2]
        if data == label_axis:
            raise ValueError(f"label_mesh's data dim {data!r} must differ from its label dim.")
        _dist.mesh_axis(mesh, data)


def _label_mesh_parts(label_mesh) -> Tuple:
    """``(mesh, label_dim)`` of a validated ``label_mesh``."""
    return label_mesh[0], label_mesh[1]


def _topk_rel(input, target, k: int, topk_method: str, label_mesh=None) -> torch.Tensor:
    """Relevance at the top-k score positions, ``(N, k)``, in rank order."""
    if label_mesh is not None:
        mesh, axis = _label_mesh_parts(label_mesh)
        return sharded_label_topk(
            input, k, mesh=mesh, label_axis=axis, method=topk_method,
            gather=target.to(torch.float32),
        )[2]
    idx = topk(input, k, method=topk_method)[1]
    return torch.gather(target.to(torch.float32), 1, idx)


def _ideal_topk(target, k: int, topk_method: str, label_mesh=None) -> torch.Tensor:
    """The top-k of the relevance row itself (the ideal ranking), through
    the same engine, so that a label-split relevance stays split."""
    t = target.to(torch.float32)
    if label_mesh is not None:
        mesh, axis = _label_mesh_parts(label_mesh)
        return sharded_label_topk(t, k, mesh=mesh, label_axis=axis, method=topk_method)[0]
    return topk_values(t, k, method=topk_method)


def _num_relevant(target: torch.Tensor, label_mesh=None) -> torch.Tensor:
    """Each row's relevant-label count: a label-axis sum, over a split
    label axis the local count plus one ``all_reduce(SUM)``."""
    local = torch.sum((target > 0).to(torch.float32), dim=1)
    if label_mesh is None:
        return local
    return _dist.all_reduce_sum(local, _dist.mesh_axis(*_label_mesh_parts(label_mesh)).group)


def _resolve_k(k: Optional[int], num_labels: int, label_mesh=None) -> int:
    """The cutoff. Over a split label axis ``k`` stays as given: columns
    past the global label count are padding whose relevance is 0, which
    adds nothing to any of the sums below; ``None`` is the global count."""
    if label_mesh is None:
        return num_labels if k is None else min(k, num_labels)
    if k is not None:
        return k
    group = _dist.mesh_axis(*_label_mesh_parts(label_mesh)).group
    return int(_dist.all_reduce_sum(torch.tensor([num_labels]), group)[0])


def _valid_or_nan(valid: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, value, torch.nan)


def _recall_kernel(input, target, k, topk_method, label_mesh=None):
    k = _resolve_k(k, input.shape[1], label_mesh)
    hits = torch.sum(
        (_topk_rel(input, target, k, topk_method, label_mesh) > 0).to(torch.float32), dim=1
    )
    m = _num_relevant(target, label_mesh)
    return _valid_or_nan(m > 0, hits / torch.clamp(m, min=1.0))


def _map_kernel(input, target, k, topk_method, label_mesh=None):
    k = _resolve_k(k, input.shape[1], label_mesh)
    rel = (_topk_rel(input, target, k, topk_method, label_mesh) > 0).to(torch.float32)
    ranks = torch.arange(1, k + 1, dtype=torch.float32, device=input.device)
    prec = torch.cumsum(rel, dim=1) / ranks
    m = _num_relevant(target, label_mesh)
    denom = torch.clamp(torch.clamp(m, max=float(k)), min=1.0)
    return _valid_or_nan(m > 0, torch.sum(rel * prec, dim=1) / denom)


def _ndcg_kernel(input, target, k, topk_method, label_mesh=None):
    k = _resolve_k(k, input.shape[1], label_mesh)
    disc = 1.0 / torch.log2(torch.arange(k, dtype=torch.float32, device=input.device) + 2.0)
    dcg = torch.sum(_topk_rel(input, target, k, topk_method, label_mesh) * disc, dim=1)
    ideal = _ideal_topk(target, k, topk_method, label_mesh)
    # rows with fewer than k relevant labels: the tail holds the row's own
    # non-positive relevance, which adds nothing
    idcg = torch.sum(torch.clamp(ideal, min=0.0) * disc, dim=1)
    positive = idcg > 0
    return _valid_or_nan(positive, dcg / torch.where(positive, idcg, 1.0))


def _hit_rate_kernel(input, target, k, topk_method, label_mesh=None):
    k = _resolve_k(k, input.shape[1], label_mesh)
    hit = torch.amax(
        (_topk_rel(input, target, k, topk_method, label_mesh) > 0).to(torch.float32), dim=1
    )
    return _valid_or_nan(_num_relevant(target, label_mesh) > 0, hit)


def _entry(kernel, input, target, k, topk_method, label_mesh):
    input, target = as_tensor(input), as_tensor(target)
    _retrieval_input_check(input, target, k)
    _check_label_mesh(label_mesh)
    return kernel(input, target, k, topk_method, label_mesh)


def recall_at_k(
    input,
    target,
    *,
    k: Optional[int] = None,
    topk_method: str = "auto",
    label_mesh: Optional[Tuple] = None,
) -> torch.Tensor:
    """Per-sample Recall@k: relevant labels ranked in the top ``k`` over the
    row's count of relevant labels (NaN for a row with none).

    Args:
        input: scores or logits ``(num_samples, num_labels)``.
        target: relevance ``(num_samples, num_labels)`` (``> 0`` is relevant).
        k: cutoff; ``None`` (or ``k >= num_labels``) ranks every label.
        topk_method: the lowering of ``ops/topk.py``.
        label_mesh: ``(DeviceMesh, label_dim)``: ``input`` and ``target``
            are this rank's label tiles (see the module doc).
    """
    return _entry(_recall_kernel, input, target, k, topk_method, label_mesh)


def map_at_k(
    input,
    target,
    *,
    k: Optional[int] = None,
    topk_method: str = "auto",
    label_mesh: Optional[Tuple] = None,
) -> torch.Tensor:
    """Per-sample MAP@k (truncated average precision): ``(1 / min(m, k)) *
    sum_j rel_j * precision@j`` with ``m`` the row's relevant count (NaN for
    a row with none). Arguments as :func:`recall_at_k`."""
    return _entry(_map_kernel, input, target, k, topk_method, label_mesh)


def ndcg_at_k(
    input,
    target,
    *,
    k: Optional[int] = None,
    topk_method: str = "auto",
    label_mesh: Optional[Tuple] = None,
) -> torch.Tensor:
    """Per-sample NDCG@k: linear graded gains, ``1 / log2(rank + 2)``
    discounts, normalised by the row's ideal DCG@k (NaN where that is
    zero). Arguments as :func:`recall_at_k`."""
    return _entry(_ndcg_kernel, input, target, k, topk_method, label_mesh)


def retrieval_hit_rate(
    input,
    target,
    *,
    k: Optional[int] = None,
    topk_method: str = "auto",
    label_mesh: Optional[Tuple] = None,
) -> torch.Tensor:
    """Per-sample HitRate@k over a relevance matrix: 1.0 if any relevant
    label ranks in the top ``k`` (NaN for a row with none). Arguments as
    :func:`recall_at_k`."""
    return _entry(_hit_rate_kernel, input, target, k, topk_method, label_mesh)
