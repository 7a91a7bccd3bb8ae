"""Exact precision-recall curve metric classes.

JAX counterpart: ``torcheval_tpu/metrics/classification/precision_recall_curve.py``
(``BinaryPrecisionRecallCurve``, ``MulticlassPrecisionRecallCurve``), exact
mode: the state is the raw sample cache, and ``compute()`` runs the
functional curve over it (one sort on the device, the trim on the host).
The ``approx=`` sketch mode is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_update_input_check,
    _multiclass_precision_recall_curve_update_input_check,
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
)
from torcheval_tpu_torch.metrics.sample_cache import SampleCacheMetric
from torcheval_tpu_torch.utils.devices import DeviceLike

_CurveResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class BinaryPrecisionRecallCurve(SampleCacheMetric[_CurveResult]):
    """Streaming binary precision-recall curve over every sample seen.

    Batches are cached as given (a tensor already on the metric's device is
    not copied): do not write into a tensor after passing it to
    ``update()``."""

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_cache_state("inputs")
        self._add_cache_state("targets")

    def update(self, input, target) -> "BinaryPrecisionRecallCurve":
        input, target = self._input(input), self._input(target)
        _binary_precision_recall_curve_update_input_check(input, target)
        self.inputs.append(input)
        self.targets.append(target)
        return self

    def compute(self) -> _CurveResult:
        if not self.inputs:
            empty = torch.empty(0, device=self._device)
            return empty, empty.clone(), empty.clone()
        return binary_precision_recall_curve(
            self._concat_cache("inputs"), self._concat_cache("targets")
        )


class MulticlassPrecisionRecallCurve(
    SampleCacheMetric[Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]]
):
    """Streaming one-vs-all precision-recall curves per class;
    ``num_classes`` defaults to the first batch's width."""

    def __init__(self, *, num_classes: Optional[int] = None, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self.num_classes = num_classes
        self._add_cache_state("inputs")
        self._add_cache_state("targets")

    def update(self, input, target) -> "MulticlassPrecisionRecallCurve":
        input, target = self._input(input), self._input(target)
        if self.num_classes is None and input.ndim == 2:
            self.num_classes = input.shape[1]
        _multiclass_precision_recall_curve_update_input_check(input, target, self.num_classes)
        self.inputs.append(input)
        self.targets.append(target)
        return self

    def compute(self):
        if not self.inputs:
            return [], [], []
        return multiclass_precision_recall_curve(
            self._concat_cache("inputs"),
            self._concat_cache("targets"),
            num_classes=self.num_classes,
        )
