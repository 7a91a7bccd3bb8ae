"""F1 metric classes.

JAX counterpart: ``torcheval_tpu/metrics/classification/f1_score.py``
(``MulticlassF1Score``, ``BinaryF1Score``). The fold and the compute are the
module-level functions of ``metrics/deferred.py``'s contract; ``update()``
defers the batch, and the concat fold (``_fold_per_chunk`` False) counts the
pending batches in one ``match_triple_counts``, as in the JAX package.
State is the int32 triple ``num_tp``, ``num_label``, ``num_prediction``:
scalars for ``average="micro"`` and the binary metric, ``(num_classes,)``
otherwise, all reduced by SUM.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.functional.classification.f1_score import (
    _binary_f1_input_check,
    _binary_f1_score_update,
    _f1_input_check,
    _f1_score_compute,
    _f1_score_param_check,
    _f1_score_update,
    _warn_empty_classes,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.utils.devices import DeviceLike

_STATES = ("num_tp", "num_label", "num_prediction")


def _f1_fold(input, target, num_classes, average):
    return dict(zip(_STATES, _f1_score_update(input, target, num_classes, average)))


def _binf1_fold(input, target, threshold):
    return dict(zip(_STATES, _binary_f1_score_update(input, target, threshold)))


class MulticlassF1Score(DeferredFoldMixin, Metric[torch.Tensor]):
    """Streaming multiclass F1 (``average`` in micro, macro, weighted or
    None for per-class scores)."""

    _fold_fn = staticmethod(_f1_fold)
    _compute_fn = staticmethod(_f1_score_compute)

    def __init__(
        self,
        *,
        num_classes: Optional[int] = None,
        average: Optional[str] = "micro",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _f1_score_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average
        shape = () if average == "micro" else (num_classes,)
        for name in _STATES:
            self._add_state(name, zeros_state(shape, dtype=torch.int32), reduction=Reduction.SUM)
        self._init_deferred()
        self._fold_params = (num_classes, average)
        self._compute_params = (average,)

    def _update_check(self, input, target) -> None:
        _f1_input_check(input, target, self.num_classes, "multiclass f1 score")

    def update(self, input, target) -> "MulticlassF1Score":
        self._defer(self._input(input), self._input(target))
        return self

    def _on_window_result(self, result):
        if self.average != "micro":
            _warn_empty_classes(self.num_label)
        return result

    def compute(self) -> torch.Tensor:
        return self._deferred_compute()

    def merge_state(self, metrics: Iterable["MulticlassF1Score"]) -> "MulticlassF1Score":
        metrics = self._fold_for_merge(metrics)
        for metric in metrics:
            for name in _STATES:
                setattr(self, name, getattr(self, name) + getattr(metric, name).to(self._device))
        return self


class BinaryF1Score(MulticlassF1Score):
    """Streaming binary F1 after thresholding the scores at ``threshold``."""

    _fold_fn = staticmethod(_binf1_fold)

    def __init__(self, *, threshold: float = 0.5, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self.threshold = threshold
        self._fold_params = (threshold,)

    def _update_check(self, input, target) -> None:
        _binary_f1_input_check(input, target)
