"""Quantile metric: streaming quantiles on bounded memory.

JAX counterpart: ``torcheval_tpu/metrics/aggregation/quantile.py``. The
state is one fixed-size int32 bucket-count tensor over the float-prefix
buckets of ``sketch/`` and an int32 NaN count, folded by the value fold (one
segment-sum launch, ``csrc/scatter.cu`` on the card); updates defer like
every aggregation metric (``metrics/deferred.py``), merges and syncs add
buckets, and ``state_dict`` holds plain tensors. ``compute()`` returns, for
each requested ``q``, the representative of the bucket holding the order
statistic of rank ``ceil(q * n)``: within ``sketch.relative_error(bits)``
of the exact order statistic for any distribution (the rank itself is
exact: counts are integers). The metric is always a sketch
(``_always_approx``).

Deferred batches of one shape fold stacked, as the JAX package's ``vmap``
does: the value fold's bucket counts have a ``torch.func.vmap`` rule, one
segment sum over ``batch * B + bucket`` for all the batches.
"""

from __future__ import annotations

import math
from typing import Iterable, Union

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.sketch.buckets import DEFAULT_BUCKET_BITS, check_bucket_bits
from torcheval_tpu_torch.sketch.cache import raise_sketch_overflow
from torcheval_tpu_torch.sketch.histogram import (
    counts_exactness_flag,
    quantiles_from_counts,
    value_hist_fold,
)
from torcheval_tpu_torch.utils.devices import DeviceLike


def _quantile_fold(input, bucket_bits):
    counts, nan = value_hist_fold(input, bucket_bits)
    return {"bucket_counts": counts, "nan_dropped": nan}


def _quantile_compute(bucket_counts, nan_dropped, q, bucket_bits):
    values = quantiles_from_counts(bucket_counts, q, bucket_bits)
    return values[0] if len(q) == 1 else values


class Quantile(DeferredFoldMixin, Metric[torch.Tensor]):
    """Streaming quantile estimates over every element seen.

    Args:
        q: quantile(s) in ``[0, 1]``: a float gives a scalar, a sequence one
            value per entry.
        bucket_count: sketch size (a power of two, 2^10 to 2^20); 4 bytes a
            bucket; the relative error is
            ``sketch.relative_error(log2(bucket_count))``.
        nan_policy: ``"error"`` (default) raises at ``compute()`` if any
            NaN reached the fold; ``"ignore"`` leaves NaN out (still counted
            in ``nan_dropped``).

    An empty metric computes NaN.
    """

    _fold_fn = staticmethod(_quantile_fold)
    _fold_per_chunk = True
    _compute_fn = staticmethod(_quantile_compute)
    # the state is a sketch already: enable_metric_approx has nothing to do
    _always_approx = True

    def __init__(
        self,
        q: Union[float, Iterable[float]] = 0.5,
        *,
        bucket_count: int = 1 << DEFAULT_BUCKET_BITS,
        nan_policy: str = "error",
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        qs = (float(q),) if isinstance(q, (int, float)) else tuple(float(x) for x in q)
        if not qs or any(not (0.0 <= x <= 1.0) or math.isnan(x) for x in qs):
            raise ValueError(f"q must be (a sequence of) floats in [0, 1], got {q!r}.")
        if nan_policy not in ("error", "ignore"):
            raise ValueError(f'nan_policy must be "error" or "ignore", got {nan_policy!r}.')
        bits = int(bucket_count).bit_length() - 1
        if bucket_count <= 0 or (1 << bits) != int(bucket_count):
            raise ValueError(f"bucket_count must be a power of two, got {bucket_count}.")
        check_bucket_bits(bits)
        self.q = qs
        self.nan_policy = nan_policy
        self._bucket_bits = bits
        self._add_state(
            "bucket_counts", zeros_state((1 << bits,), dtype=torch.int32), reduction=Reduction.SUM
        )
        self._add_state("nan_dropped", zeros_state((), dtype=torch.int32), reduction=Reduction.SUM)
        self._init_deferred()
        self._fold_params = (bits,)
        self._compute_params = (qs, bits)

    # sync rejects replicas whose sketches cannot add (another bucket_count)
    # or whose results differ (another q)
    @property
    def _sync_schema_extra(self):
        return (self._bucket_bits, self.q)

    def update(self, input) -> "Quantile":
        self._defer(self._input(input))
        return self

    def compute(self) -> torch.Tensor:
        result = self._deferred_compute()
        # the int32-exact edge fails closed; past ~2.1e9 samples the rank
        # cumsum would wrap
        raise_sketch_overflow(counts_exactness_flag(self.bucket_counts))
        if self.nan_policy == "error":
            dropped = int(self.nan_dropped)
            if dropped:
                raise ValueError(
                    f"{dropped} NaN value(s) reached the quantile sketch; NaN "
                    "has no order. Filter NaNs before update() or pass "
                    'nan_policy="ignore".'
                )
        return result

    def merge_state(self, metrics: Iterable["Quantile"]) -> "Quantile":
        metrics = self._fold_for_merge(metrics)
        for metric in metrics:
            self.bucket_counts = self.bucket_counts + metric.bucket_counts.to(self._device)
            self.nan_dropped = self.nan_dropped + metric.nan_dropped.to(self._device)
        return self
