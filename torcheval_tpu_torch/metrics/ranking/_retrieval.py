"""Shared base of the retrieval metrics (NDCG@k, MAP@k, Recall@k).

JAX counterpart: ``torcheval_tpu/metrics/ranking/_retrieval.py``. They are
means over valid rows, so their state is two scalars: ``score_sum``
(float32) and ``num_valid`` (int32), both ``Reduction.SUM``. The label axis
lives only inside the top-k engine call of each fold, never in state. The
classes defer their folds (``metrics/deferred.py``): the top-k kernel has no
``torch.func.vmap`` rule (``_fold_vmap = False``), so the batches of a window
fold one by one, as the JAX ``lax.scan`` folds them.

``label_mesh=(mesh, label_dim)`` folds each batch through the label-split
engine (``functional/ranking/retrieval.py``): ``update()`` takes this
rank's label tiles, and each fold runs the group's collectives, so every
rank of the label group folds the same batches in the same order. After
the merge every rank of the group holds the same state; sync such metrics
over the data ranks only (the toolkit's ``processes=``, e.g. the ranks of
the mesh's data dim), or each row counts once per label rank.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.functional.ranking.retrieval import (
    _check_label_mesh,
    _retrieval_input_check,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.ops.topk import _METHODS as _TOPK_METHODS
from torcheval_tpu_torch.utils.devices import DeviceLike


def _retrieval_fold(input, target, kernel, k, topk_method, label_mesh):
    """One batch's ``score_sum`` and ``num_valid`` deltas from the
    subclass's NaN-poisoned per-sample scores."""
    per_sample = kernel(input, target, k, topk_method, label_mesh)
    valid = ~torch.isnan(per_sample)
    return {
        "score_sum": torch.sum(torch.where(valid, per_sample, 0.0)),
        "num_valid": valid.sum(dtype=torch.int32),
    }


def _mean_compute(score_sum, num_valid):
    """The mean over valid rows; NaN before the first valid row."""
    return torch.where(
        num_valid > 0,
        score_sum / torch.clamp(num_valid, min=1).to(torch.float32),
        torch.nan,
    )


class RetrievalMeanMetric(DeferredFoldMixin, Metric[torch.Tensor]):
    """Mean of a per-sample retrieval score over the rows where it is not
    NaN. Subclasses set ``_kernel``, a function of ``(input, target, k,
    topk_method)`` from ``functional/ranking/retrieval.py``."""

    _kernel = None
    _fold_fn = staticmethod(_retrieval_fold)
    _fold_per_chunk = True
    _fold_vmap = False
    _compute_fn = staticmethod(_mean_compute)

    def __init__(
        self,
        *,
        k: Optional[int] = None,
        topk_method: str = "auto",
        label_mesh: Optional[Tuple] = None,
        device: DeviceLike = None,
    ) -> None:
        if k is not None and (type(k) is not int or k <= 0):
            raise ValueError(f"k should be None or a positive int, got {k!r}.")
        if topk_method not in _TOPK_METHODS:
            raise ValueError(
                f"topk_method must be one of {_TOPK_METHODS}, got {topk_method!r}."
            )
        _check_label_mesh(label_mesh)
        super().__init__(device=device)
        self.k = k
        self.topk_method = topk_method
        self.label_mesh = label_mesh
        self._add_state(
            "score_sum", zeros_state((), dtype=torch.float32), reduction=Reduction.SUM
        )
        self._add_state(
            "num_valid", zeros_state((), dtype=torch.int32), reduction=Reduction.SUM
        )
        self._init_deferred()
        self._fold_params = (type(self)._kernel, k, topk_method, label_mesh)

    def _update_check(self, input, target) -> None:
        _retrieval_input_check(input, target, self.k)

    def update(self, input, target):
        self._defer(self._input(input), self._input(target))
        return self

    def compute(self) -> torch.Tensor:
        """The mean over valid rows; NaN before the first valid row."""
        return self._deferred_compute()

    def merge_state(self, metrics: Iterable["RetrievalMeanMetric"]):
        metrics = self._fold_for_merge(metrics)
        for metric in metrics:
            self.score_sum = self.score_sum + metric.score_sum.to(self._device)
            self.num_valid = self.num_valid + metric.num_valid.to(self._device)
        return self
