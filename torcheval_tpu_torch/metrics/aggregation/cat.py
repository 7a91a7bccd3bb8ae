"""Cat metric: concatenate every input seen.

JAX counterpart: ``torcheval_tpu/metrics/aggregation/cat.py`` (reference:
``torcheval/metrics/aggregation/cat.py``). In exact mode the state is a
sample cache; ``merge_state`` keeps the reference's quirk of concatenating
each source's cache along that source's own ``dim`` before appending it.

With ``approx=`` the unbounded cache becomes a resident value sketch
(``sketch/``), and ``compute()`` returns the weighted-histogram view
``(values, counts)`` over the nonempty buckets: bucket representatives and
their multiplicities, each value within ``sketch.relative_error(bits)``.
The sketch pools elements, so it needs ``dim=0``: ``approx=`` with another
``dim`` raises, and the ``TORCHEVAL_TPU_APPROX`` environment variable alone
leaves such a metric exact and logs that once.
"""

from __future__ import annotations

from typing import Iterable, Tuple, Union

import torch

from torcheval_tpu_torch.metrics.sample_cache import SampleCacheMetric
from torcheval_tpu_torch.metrics.state import Reduction
from torcheval_tpu_torch.sketch.buckets import DEFAULT_BUCKET_BITS, representatives_on
from torcheval_tpu_torch.sketch.cache import (
    ValueSketchCacheMixin,
    raise_sketch_overflow,
    resolve_approx,
)
from torcheval_tpu_torch.utils.devices import DeviceLike
from torcheval_tpu_torch.utils.telemetry import log_once


class Cat(ValueSketchCacheMixin, SampleCacheMetric[torch.Tensor]):
    """Concatenate all input tensors along ``dim`` (with ``approx=``, keep a
    bounded value sketch instead: module doc).

    Batches are cached as given (a tensor already on the metric's device is
    not copied): do not write into a tensor after passing it to
    ``update()``."""

    def __init__(self, *, dim: int = 0, approx=None, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self.dim = dim
        bits = resolve_approx(approx, default_bits=DEFAULT_BUCKET_BITS)
        if bits is not None and dim != 0:
            if approx is None:
                log_once(
                    "cat_approx_needs_dim0",
                    "TORCHEVAL_TPU_APPROX is set but Cat(dim=%d) cannot sketch (the "
                    "sketch pools elements; higher-dimension concat structure is not "
                    "representable): this metric stays exact.",
                    dim,
                )
                bits = None
            else:
                raise ValueError(
                    "approx= requires dim=0: the sketch pools elements and "
                    "cannot represent higher-dimension concat structure."
                )
        # CAT is an axis-0 concatenation; another dim merges only through
        # merge_state, so the sync must take the CUSTOM route
        if dim == 0:
            self._add_cache_state("inputs")
        else:
            self._add_state("inputs", [], reduction=Reduction.CUSTOM)
        if bits is not None:
            self._init_value_sketch(bits, "inputs")

    def update(self, input) -> "Cat":
        input = self._input(input)
        self.inputs.append(input)
        if self._sketch_enabled():
            self._sketch_stage(input)
        return self

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        if self._sketch_enabled():
            counts, nan, overflow = self._sketch_counts_parts()
            raise_sketch_overflow(overflow)
            self._sketch_check_nan(nan)
            keep = counts > 0
            return representatives_on(self._sketch_bits, counts.device)[keep], counts[keep]
        if not self.inputs:
            return torch.empty(0, device=self._device)
        return torch.cat(self.inputs, dim=self.dim)

    def merge_state(self, metrics: Iterable["Cat"]) -> "Cat":
        metrics = list(metrics)
        for metric in metrics:
            if metric.inputs:
                self.inputs.append(torch.cat(metric.inputs, dim=metric.dim).to(self._device))
        if self._sketch_enabled():
            self._sketch_merge_from(metrics)
            self._sketch_recount()
        return self

    def _prepare_for_merge_state(self) -> None:
        if self._sketch_enabled():
            self._sketch_fold()
        if self.inputs:
            self.inputs = [torch.cat(self.inputs, dim=self.dim)]
