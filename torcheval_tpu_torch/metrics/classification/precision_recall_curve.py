"""Precision-recall curve metric classes.

JAX counterpart: ``torcheval_tpu/metrics/classification/precision_recall_curve.py``
(``BinaryPrecisionRecallCurve``, ``MulticlassPrecisionRecallCurve``). In
exact mode the state is the raw sample cache, and ``compute()`` runs the
functional curve over it (one sort on the device, the trim on the host).

With ``approx=`` (or the ``TORCHEVAL_TPU_APPROX`` environment variable) the
cache becomes a staging buffer folded into resident ``(tp, fp)`` bucket
histograms (``sketch/``), and ``compute()`` returns the curve over the
nonempty buckets with the bucket representatives as thresholds: one point
an occupied bucket, thresholds within the sketch's relative error of the
scores, counts across buckets exact. Memory is O(buckets) for any stream
length; merges add buckets. The multiclass sketch needs ``num_classes`` at
construction (it sizes the ``(C, B)`` state); when only the environment
variable asks for it and ``num_classes`` is missing, the metric stays exact
and logs that once.
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
from torcheval_tpu_torch.sketch.buckets import DEFAULT_BUCKET_BITS, DEFAULT_MC_BUCKET_BITS
from torcheval_tpu_torch.sketch.cache import (
    ScoreSketchCacheMixin,
    raise_sketch_overflow,
    resolve_approx,
    sketch_mc_prc_from_parts,
    sketch_prc_from_parts,
)
from torcheval_tpu_torch.sketch.histogram import trim_hist_curve
from torcheval_tpu_torch.utils.devices import DeviceLike
from torcheval_tpu_torch.utils.telemetry import log_once

_CurveResult = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class BinaryPrecisionRecallCurve(ScoreSketchCacheMixin, SampleCacheMetric[_CurveResult]):
    """Streaming binary precision-recall curve over every sample seen (with
    ``approx=``, over the resident sketch: module doc).

    Batches are cached as given (a tensor already on the metric's device is
    not copied): do not write into a tensor after passing it to
    ``update()``."""

    def __init__(self, *, approx=None, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_cache_state("inputs")
        self._add_cache_state("targets")
        bits = resolve_approx(approx, default_bits=DEFAULT_BUCKET_BITS)
        if bits is not None:
            self._init_score_sketch(bits)

    def update(self, input, target) -> "BinaryPrecisionRecallCurve":
        input, target = self._input(input), self._input(target)
        _binary_precision_recall_curve_update_input_check(input, target)
        self.inputs.append(input)
        self.targets.append(target)
        if self._sketch_enabled():
            self._score_sketch_stage(input.shape[0])
        return self

    def compute(self) -> _CurveResult:
        if self._sketch_enabled():
            precision, recall, nonempty, nan, overflow = sketch_prc_from_parts(
                *self._score_sketch_parts(), self._sketch_bits
            )
            raise_sketch_overflow(overflow)
            self._sketch_check_nan(nan)
            return trim_hist_curve(precision, recall, nonempty, self._sketch_bits)
        if not self.inputs:
            empty = torch.empty(0, device=self._device)
            return empty, empty.clone(), empty.clone()
        return binary_precision_recall_curve(
            self._concat_cache("inputs"), self._concat_cache("targets")
        )


class MulticlassPrecisionRecallCurve(
    ScoreSketchCacheMixin,
    SampleCacheMetric[Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]],
):
    """Streaming one-vs-all precision-recall curves per class;
    ``num_classes`` defaults to the first batch's width (with ``approx=`` it
    is required at construction)."""

    def __init__(
        self, *, num_classes: Optional[int] = None, approx=None, device: DeviceLike = None
    ) -> None:
        super().__init__(device=device)
        self.num_classes = num_classes
        self._add_cache_state("inputs")
        self._add_cache_state("targets")
        bits = resolve_approx(approx, default_bits=DEFAULT_MC_BUCKET_BITS)
        if bits is not None and num_classes is None:
            if approx is None:
                # the environment cannot size the (C, B) state: stay exact,
                # loudly, rather than raise in code that never asked
                log_once(
                    "mc_prc_approx_needs_num_classes",
                    "TORCHEVAL_TPU_APPROX is set but MulticlassPrecisionRecallCurve "
                    "was built without num_classes; the sketch state cannot be "
                    "sized, so this metric stays exact. Pass num_classes= to opt in.",
                )
                bits = None
            else:
                raise ValueError(
                    "approx= requires num_classes at construction (it sizes "
                    "the per-class sketch state)."
                )
        if bits is not None:
            self._init_score_sketch(bits, num_classes=num_classes)

    def update(self, input, target) -> "MulticlassPrecisionRecallCurve":
        input, target = self._input(input), self._input(target)
        if self.num_classes is None and input.ndim == 2:
            self.num_classes = input.shape[1]
        _multiclass_precision_recall_curve_update_input_check(input, target, self.num_classes)
        self.inputs.append(input)
        self.targets.append(target)
        if self._sketch_enabled():
            self._score_sketch_stage(input.shape[0])
        return self

    def compute(self):
        if self._sketch_enabled():
            precision, recall, nonempty, nan, overflow = sketch_mc_prc_from_parts(
                *self._score_sketch_parts(), self._sketch_bits, self.num_classes
            )
            raise_sketch_overflow(overflow)
            self._sketch_check_nan(nan, "per-class score entry(ies)")
            precisions, recalls, thresholds = [], [], []
            for c in range(self.num_classes):
                pc, rc, tc = trim_hist_curve(
                    precision[c], recall[c], nonempty[c], self._sketch_bits
                )
                precisions.append(pc)
                recalls.append(rc)
                thresholds.append(tc)
            return precisions, recalls, thresholds
        if not self.inputs:
            return [], [], []
        return multiclass_precision_recall_curve(
            self._concat_cache("inputs"),
            self._concat_cache("targets"),
            num_classes=self.num_classes,
        )
