"""BinaryAUROC / BinaryAUPRC metrics, exact mode.

JAX counterpart: ``torcheval_tpu/metrics/classification/auroc.py``
(``_CompactingCacheLifecycle``, ``_BinaryCurveMetric``, ``BinaryAUROC``,
``BinaryAUPRC``). Update appends the batch to a sample cache. With
``compaction_threshold`` set, once the raw cache holds that many samples it
is folded into a bounded, exact summary of (score, tp, fp) rows per unique
threshold (``ops/summary.py``), so memory follows the stream's score
cardinality and not its sample count, and results equal the all-samples
sort. The fold is one sort plus the stream-compaction kernel
(``csrc/stream_compact.cu``) on the card.

Not in this slice: the ``approx=`` sketch mode, the sharded and distributed
curve paths, and the multiclass curve metrics.
"""

from __future__ import annotations

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _auroc_update_input_check,
)
from torcheval_tpu_torch.metrics.sample_cache import SampleCacheMetric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.ops.curves import (
    binary_auprc_counts_kernel,
    binary_auprc_counts_presorted_kernel,
    binary_auprc_kernel,
    binary_auroc_counts_kernel,
    binary_auroc_counts_presorted_kernel,
    binary_auroc_kernel,
)
from torcheval_tpu_torch.ops.summary import PAD_SCORE, compact_counts, compact_counts_fast
from torcheval_tpu_torch.utils.devices import DeviceLike


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


# compaction buffers pad to a multiple of 4M rows once past 4M (a power of
# two below): a bounded set of buffer sizes over a metric's life with at
# most a few percent of padding at the working size of a billion-row stream
_PAD_GRANULE = 1 << 22


def _pad_cap(n: int) -> int:
    if n <= _PAD_GRANULE:
        return _next_pow2(n)
    return ((n + _PAD_GRANULE - 1) // _PAD_GRANULE) * _PAD_GRANULE


def _combined_counts(raw_s, raw_t, sum_s, sum_tp, sum_fp):
    """Raw caches (unit counts) and summary caches (aggregated counts) as
    one (score, tp, fp) column set."""
    parts_s, parts_tp, parts_fp = [], [], []
    if raw_s:
        t = torch.cat(raw_t).to(torch.int32)
        parts_s.append(torch.cat(raw_s))
        parts_tp.append(t)
        parts_fp.append(1 - t)
    if sum_s:
        parts_s.append(torch.cat(sum_s))
        parts_tp.append(torch.cat(sum_tp))
        parts_fp.append(torch.cat(sum_fp))
    return torch.cat(parts_s), torch.cat(parts_tp), torch.cat(parts_fp)


def _auroc_from_parts(raw_s, raw_t, sum_s, sum_tp, sum_fp):
    if not sum_s:
        # raw-only cache: the unit-count sort moves the target alone
        return binary_auroc_kernel(torch.cat(raw_s), torch.cat(raw_t))
    return binary_auroc_counts_kernel(
        *_combined_counts(raw_s, raw_t, sum_s, sum_tp, sum_fp)
    )


def _auprc_from_parts(raw_s, raw_t, sum_s, sum_tp, sum_fp):
    if not sum_s:
        return binary_auprc_kernel(torch.cat(raw_s), torch.cat(raw_t))
    return binary_auprc_counts_kernel(
        *_combined_counts(raw_s, raw_t, sum_s, sum_tp, sum_fp)
    )


# Fold pipeline:
#   "auto" - one sort + stream compaction (compact_counts_fast): the CUDA
#            kernel for state on the card, its plain version on the CPU
#   "off"  - the two-sort compact_counts
STREAM_COMPACTION = "auto"


def _compact_parts(raw_s, raw_t, sum_s, sum_tp, sum_fp, nan_acc, cap: int, fast: bool):
    """Fold + pad-to-cap + compact. Returns ``(s, tp, fp, n_unique,
    nan_acc')``; the NaN-sample count accumulates on the device and is
    checked once, at ``compute()``."""
    s, tp, fp = _combined_counts(raw_s, raw_t, sum_s, sum_tp, sum_fp)
    n = s.shape[0]
    if cap > n:
        s = torch.cat([s, s.new_full((cap - n,), PAD_SCORE)])
        tp = torch.cat([tp, tp.new_zeros(cap - n)])
        fp = torch.cat([fp, fp.new_zeros(cap - n)])
    compact = compact_counts_fast if fast else compact_counts
    s, tp, fp, n_unique, nan_dropped = compact(s, tp, fp)
    return s, tp, fp, n_unique, nan_acc + nan_dropped


class _CompactingCacheLifecycle:
    """Compaction lifecycle of the sample-cache curve metrics: the threshold,
    the cache-row counter every state mutation keeps true, the device-side
    NaN-sample flag, and the merge/reset/load hooks. Subclasses implement
    :meth:`_compact` and register their states via :meth:`_init_compaction`.
    """

    def _init_compaction(self, compaction_threshold: Optional[int]) -> None:
        if compaction_threshold is not None and compaction_threshold <= 0:
            raise ValueError(
                f"compaction_threshold must be positive or None, got "
                f"{compaction_threshold}."
            )
        self._compaction_threshold = compaction_threshold
        self._cached_samples = 0
        self._nan_checked = True  # no compactions yet -> nothing to check
        # True while the summary is known to be ONE buffer of unique rows in
        # descending order with NaN padding last (every _compact output is);
        # merged or loaded state clears it until the next compaction. Gates
        # the sort-free presorted compute.
        self._summary_sorted = True
        self._add_cache_state("inputs")
        self._add_cache_state("targets")
        self._add_cache_state("summary_scores")
        self._add_cache_state("summary_tp")
        self._add_cache_state("summary_fp")
        self._add_state(
            "summary_nan_dropped",
            zeros_state((), dtype=torch.int32),
            reduction=Reduction.SUM,
        )

    def _compact(self) -> None:
        raise NotImplementedError

    def _count_cached_update(self, n_rows: int) -> None:
        self._cached_samples += n_rows
        if (
            self._compaction_threshold is not None
            and self._cached_samples >= self._compaction_threshold
        ):
            self._compact()

    def _set_states(self, values) -> None:
        # any installed state may carry a nonzero NaN flag or an unsorted
        # summary from another replica
        super()._set_states(values)
        if "summary_nan_dropped" in values:
            self._nan_checked = False
        if any(k.startswith("summary_") for k in values):
            self._summary_sorted = False

    def _install_compacted(self, s, tp, fp, n_unique, nan_acc) -> None:
        """Install a compaction's output: the adaptive trim's one host read
        (``n_unique``, one sync per fold), the NaN counter, and the five
        cache states."""
        self.summary_nan_dropped = nan_acc
        self._nan_checked = False
        keep = min(s.shape[0], _pad_cap(max(int(n_unique.item()), 1)))
        self.inputs = []
        self.targets = []
        # clone: a slice would keep the whole padded fold buffer alive
        self.summary_scores = [s[:keep].clone()]
        self.summary_tp = [tp[:keep].clone()]
        self.summary_fp = [fp[:keep].clone()]
        self._cached_samples = 0
        self._summary_sorted = True

    def _check_nan_flag(self) -> None:
        """Raise at compute time if NaN-scored samples ever reached a
        compaction: one host read, skipped when no compaction happened
        since the last clean check."""
        if self._nan_checked:
            return
        dropped = int(self.summary_nan_dropped.item())
        # only a CLEAN check is cached: poisoned state keeps raising
        self._nan_checked = dropped == 0
        if dropped:
            raise ValueError(
                f"{dropped} sample(s) with NaN scores reached "
                "compaction; "
                "NaN is the summary padding sentinel and such samples cannot "
                "be represented (the uncompacted metric would count them). "
                "Filter NaNs before update() or use "
                "compaction_threshold=None."
            )

    def _prepare_for_merge_state(self) -> None:
        # compacting metrics ship their bounded summary, not the raw cache
        if self._compaction_threshold is not None:
            self._compact()
        super()._prepare_for_merge_state()

    # every path that rewrites the raw cache keeps _cached_samples true, or
    # merge-fed accumulators would never compact and reset metrics would
    # compact spuriously
    def _recount_cache(self) -> None:
        self._cached_samples = sum(int(a.shape[0]) for a in self.inputs)
        if self._compaction_threshold is None:
            return
        # compact when raw rows exceed the threshold, OR when merges have
        # fragmented the summary into several buffers past the threshold; a
        # single summary buffer never re-triggers, so this cannot loop
        summary_rows = sum(int(a.shape[0]) for a in self.summary_scores)
        if self._cached_samples >= self._compaction_threshold or (
            len(self.summary_scores) > 1 and summary_rows >= self._compaction_threshold
        ):
            self._compact()

    def merge_state(self, metrics):
        metrics = list(metrics)
        self._summary_sorted = False  # concatenated segments may overlap
        super().merge_state(metrics)
        for metric in metrics:
            # the NaN flag is additive across replicas
            self.summary_nan_dropped = self.summary_nan_dropped + (
                metric.summary_nan_dropped.to(self._device)
            )
        self._nan_checked = False
        self._recount_cache()
        return self

    def reset(self):
        super().reset()
        self._cached_samples = 0
        self._nan_checked = True
        self._summary_sorted = True
        return self

    def load_state_dict(self, state_dict, strict: bool = True) -> None:
        self._summary_sorted = False  # unknown provenance
        super().load_state_dict(state_dict, strict)
        self._nan_checked = False
        self._recount_cache()


class _BinaryCurveMetric(_CompactingCacheLifecycle, SampleCacheMetric[torch.Tensor]):
    """Cache and compaction machinery of the binary curve metrics.

    State is five CAT caches: raw ``inputs``/``targets`` and a summary of
    ``summary_scores`` (float32, NaN padding) and ``summary_tp``/``summary_fp``
    (int32 counts, exact while the stream's total positives and negatives
    each stay below 2^31), plus the ``summary_nan_dropped`` SUM scalar.
    Concatenated summaries may repeat a threshold; the curve functions merge
    tied scores, so no re-compaction is needed for correctness.

    Batches are cached as given (a tensor already on the metric's device is
    not copied), as in the reference torcheval: do not write into a tensor
    after passing it to ``update()``.
    """

    def __init__(
        self, *, compaction_threshold: Optional[int] = None, device: DeviceLike = None
    ) -> None:
        super().__init__(device=device)
        self._init_compaction(compaction_threshold)

    def update(self, input, target) -> "_BinaryCurveMetric":
        input, target = self._input(input), self._input(target)
        _auroc_update_input_check(input, target)
        self.inputs.append(input)
        self.targets.append(target)
        self._count_cached_update(input.shape[0])
        return self

    def _compact(self) -> None:
        """Fold raw cache + summary into one padded unique-threshold summary,
        padded to a 4M-row granule (a power of two below that)."""
        n = sum(int(a.shape[0]) for a in self.inputs) + sum(
            int(a.shape[0]) for a in self.summary_scores
        )
        if n == 0:
            return
        self._install_compacted(
            *_compact_parts(
                self.inputs,
                self.targets,
                self.summary_scores,
                self.summary_tp,
                self.summary_fp,
                self.summary_nan_dropped,
                _pad_cap(n),
                STREAM_COMPACTION != "off",
            )
        )

    def _presorted_summary(self):
        """``(s, tp, fp)`` when the state is a single summary buffer known to
        be sorted and unique, else None. Raw leftovers give None rather than
        a forced compaction: feeding them to the sorting compute is less
        work than a compaction followed by the presorted compute."""
        if self._compaction_threshold is None or STREAM_COMPACTION == "off":
            return None
        if not self._summary_sorted or self.inputs or len(self.summary_scores) != 1:
            return None
        return self.summary_scores[0], self.summary_tp[0], self.summary_fp[0]

    def _value(self, empty: float, presorted_fn, from_parts):
        if not (self.inputs or self.summary_scores):
            return torch.tensor(empty, device=self._device)
        presorted = self._presorted_summary()
        if presorted is not None:
            result = presorted_fn(*presorted)
        else:
            result = from_parts(
                self.inputs,
                self.targets,
                self.summary_scores,
                self.summary_tp,
                self.summary_fp,
            )
        self._check_nan_flag()
        return result


class BinaryAUROC(_BinaryCurveMetric):
    """Streaming area under the ROC curve (exact, sort-based).

    By default the state is the full sample cache; with
    ``compaction_threshold`` set, it is a bounded exact unique-threshold
    summary."""

    def compute(self) -> torch.Tensor:
        return self._value(
            0.5, binary_auroc_counts_presorted_kernel, _auroc_from_parts
        )


class BinaryAUPRC(_BinaryCurveMetric):
    """Streaming area under the PR curve (average precision)."""

    def compute(self) -> torch.Tensor:
        return self._value(
            0.0, binary_auprc_counts_presorted_kernel, _auprc_from_parts
        )
