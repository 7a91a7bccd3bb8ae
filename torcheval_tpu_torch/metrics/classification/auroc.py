"""AUROC / AUPRC metrics, binary and one-vs-all multiclass.

JAX counterpart: ``torcheval_tpu/metrics/classification/auroc.py``
(``_CompactingCacheLifecycle``, ``_BinaryCurveMetric``, ``BinaryAUROC``,
``BinaryAUPRC``, the multiclass summary helpers ``_mc_*``,
``_MulticlassCurveMetric``, ``MulticlassAUROC``, ``MulticlassAUPRC``).
Update appends the batch to a sample cache. With
``compaction_threshold`` set, once the raw cache holds that many samples it
is folded into a bounded, exact summary of (score, tp, fp) rows per unique
threshold (``ops/summary.py``), so memory follows the stream's score
cardinality and not its sample count, and results equal the all-samples
sort. The fold is one sort plus the stream-compaction kernel
(``csrc/stream_compact.cu``) on the card.

The multiclass metrics keep one such summary per class, as ``(K, C)``
columns (a row per threshold entry, so that a merge concatenates on axis
0). Their fold sorts the ``(C, M)`` one-vs-all columns in one batched sort
and compacts the flattened ``C * M`` rows in one launch of the compaction
kernel; the per-class counts of kept rows place each class's rows back
into its column (``ops/summary.py::compact_count_rows_fast``).

With ``approx=`` (``True`` for the family's default bucket count, an int
for a bucket count, or the ``TORCHEVAL_TPU_APPROX`` environment variable),
the summary gives way to a resident, fixed-size score sketch, with the
lifecycle every score-sketch metric shares
(``sketch/cache.py::ScoreSketchCacheMixin``): ``sketch_tp``/``sketch_fp``
int32 bucket histograms, O(buckets) memory for any stream length, merged by
addition, with an error bound computable from the sketch itself
(``sketch.auroc_error_bound``, ``sketch.auprc_error_bound``).
``compaction_threshold``, when given, sets how many staged rows fold at once
(default ``sketch.SKETCH_FOLD_ROWS``); each fold is one launch of the
segment-sum kernel (``csrc/scatter.cu``). A ``compute()`` folds leftover
staged rows into a temporary histogram and leaves the state as it was.

**Data-parallel compute** (``parallel/evaluator.py::ShardedEvaluator``):
each rank holds its own cache, and :meth:`_CurveMetric._distributed_compute`
computes the result over a process group without gathering the samples. An
exact metric runs the distributed curve (``ops/dist_curves.py``: a bucket
exchange, a sort a rank, a few small collectives) when every rank's cache
is raw entries only; a rank whose
cache holds summary rows or a NaN flag abstains through the route's first
collective, and a NaN score or a bucket overflow shows in its error
channel, so every rank stands down together and the caller syncs by
gathering (the JAX package's fused path). An ``approx=`` metric adds every
rank's resident sketch and staged rows in one int32 all-reduce
(``sharded_sketch_counts``). The routes read the state and leave it as it
was. ``ops.dist_curves.record_call`` counts each compute by route: ``dist``,
``sketch``, or ``fused`` (every exact compute on one rank's state, the
gather route's included).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _auroc_update_input_check,
    _mc_average,
    _mc_curve_param_check,
)
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _multiclass_precision_recall_curve_update_input_check,
)
from torcheval_tpu_torch.metrics.sample_cache import SampleCacheMetric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.ops.curves import (
    binary_auprc_counts_kernel,
    binary_auprc_counts_presorted_kernel,
    binary_auprc_kernel,
    binary_auroc_counts_kernel,
    binary_auroc_counts_presorted_kernel,
    binary_auroc_parts,
    class_onehot_rows,
    multiclass_auprc_kernel,
    multiclass_auroc_kernel,
)
from torcheval_tpu_torch.ops.dist_curves import curve_value, record_call, sharded_sketch_counts
from torcheval_tpu_torch.ops.summary import PAD_SCORE, compact_count_rows_fast, compact_counts_fast
from torcheval_tpu_torch.sketch.buckets import DEFAULT_BUCKET_BITS, DEFAULT_MC_BUCKET_BITS
from torcheval_tpu_torch.sketch.cache import (
    ScoreSketchCacheMixin,
    resolve_approx,
    sketch_auprc_from_parts,
    sketch_auroc_from_parts,
)
from torcheval_tpu_torch.utils import dist as _dist
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
    one (score, tp, fp) column set. Scores become float32, the summary's
    type and the compaction kernel's 32-bit word: exact for bfloat16,
    float16 and int32 scores below 2^24, and what JAX holds float64 scores
    as (without x64)."""
    parts_s, parts_tp, parts_fp = [], [], []
    if raw_s:
        t = torch.cat(raw_t).to(torch.int32)
        parts_s.append(torch.cat(raw_s).to(torch.float32))
        parts_tp.append(t)
        parts_fp.append(1 - t)
    if sum_s:
        parts_s.append(torch.cat(sum_s))
        parts_tp.append(torch.cat(sum_tp))
        parts_fp.append(torch.cat(sum_fp))
    return torch.cat(parts_s), torch.cat(parts_tp), torch.cat(parts_fp)


def _auroc_from_parts(raw_s, raw_t, sum_s, sum_tp, sum_fp):
    if not sum_s:
        # raw-only cache: the unit-count sort moves the target alone; on the
        # card the stream route reads the parts where they lie
        return binary_auroc_parts(list(raw_s), list(raw_t))
    return binary_auroc_counts_kernel(
        *_combined_counts(raw_s, raw_t, sum_s, sum_tp, sum_fp)
    )


def _auprc_from_parts(raw_s, raw_t, sum_s, sum_tp, sum_fp):
    if not sum_s:
        return binary_auprc_kernel(torch.cat(raw_s), torch.cat(raw_t))
    return binary_auprc_counts_kernel(
        *_combined_counts(raw_s, raw_t, sum_s, sum_tp, sum_fp)
    )


def _compact_parts(raw_s, raw_t, sum_s, sum_tp, sum_fp, nan_acc, cap: int):
    """Fold + pad-to-cap + compact: one sort plus the stream compaction
    (``compact_counts_fast``; the CUDA kernel for state on the card, its
    plain version on the CPU). Returns ``(s, tp, fp, n_unique, nan_acc')``;
    the NaN-sample count accumulates on the device and is checked once, at
    ``compute()``."""
    s, tp, fp = _combined_counts(raw_s, raw_t, sum_s, sum_tp, sum_fp)
    n = s.shape[0]
    if cap > n:
        s = torch.cat([s, s.new_full((cap - n,), PAD_SCORE)])
        tp = torch.cat([tp, tp.new_zeros(cap - n)])
        fp = torch.cat([fp, fp.new_zeros(cap - n)])
    s, tp, fp, n_unique, nan_dropped = compact_counts_fast(s, tp, fp)
    return s, tp, fp, n_unique, nan_acc + nan_dropped


# ----------------------------------------------- multiclass summary helpers
def _mc_combined_counts(raw_s, raw_t, sum_s, sum_tp, sum_fp, num_classes):
    """Raw ``(N, C)`` caches and ``(K, C)`` per-class summaries as ``(C, M)``
    one-vs-all count columns, scores as float32 (see
    :func:`_combined_counts`)."""
    parts_s, parts_tp, parts_fp = [], [], []
    if raw_s:
        x = torch.cat(raw_s, dim=0).to(torch.float32)  # (N, C)
        onehot = class_onehot_rows(torch.cat(raw_t), num_classes).to(torch.int32)  # (C, N)
        parts_s.append(x.T)
        parts_tp.append(onehot)
        parts_fp.append(1 - onehot)
    if sum_s:
        parts_s.append(torch.cat(sum_s, dim=0).T)  # (C, K)
        parts_tp.append(torch.cat(sum_tp, dim=0).T)
        parts_fp.append(torch.cat(sum_fp, dim=0).T)
    return torch.cat(parts_s, dim=1), torch.cat(parts_tp, dim=1), torch.cat(parts_fp, dim=1)


def _mc_compact_parts(raw_s, raw_t, sum_s, sum_tp, sum_fp, nan_acc, cap: int, num_classes: int):
    """Per-class compaction: the binary :func:`_compact_parts` on every
    class row, the JAX package's ``jax.vmap(compact_counts)``, as one
    stream compaction over all rows (the kernel on the card). Returns
    ``(K, C)`` summary columns, the largest per-class unique count (for the
    adaptive trim) and the accumulated NaN entry count."""
    s, tp, fp = _mc_combined_counts(raw_s, raw_t, sum_s, sum_tp, sum_fp, num_classes)
    n = s.shape[1]
    if cap > n:
        pad = (num_classes, cap - n)
        s = torch.cat([s, s.new_full(pad, PAD_SCORE)], dim=1)
        tp = torch.cat([tp, tp.new_zeros(pad)], dim=1)
        fp = torch.cat([fp, fp.new_zeros(pad)], dim=1)
    s2, tp2, fp2, n_unique, nan_dropped = compact_count_rows_fast(s, tp, fp)
    return s2.T, tp2.T, fp2.T, n_unique.max(), nan_acc + nan_dropped


def _mc_auroc_from_parts(raw_s, raw_t, sum_s, sum_tp, sum_fp, num_classes):
    if not sum_s:
        return multiclass_auroc_kernel(torch.cat(raw_s, dim=0), torch.cat(raw_t))
    return binary_auroc_counts_kernel(
        *_mc_combined_counts(raw_s, raw_t, sum_s, sum_tp, sum_fp, num_classes)
    )


def _mc_auprc_from_parts(raw_s, raw_t, sum_s, sum_tp, sum_fp, num_classes):
    if not sum_s:
        return multiclass_auprc_kernel(torch.cat(raw_s, dim=0), torch.cat(raw_t))
    return binary_auprc_counts_kernel(
        *_mc_combined_counts(raw_s, raw_t, sum_s, sum_tp, sum_fp, num_classes)
    )


def _mc_auroc_presorted(s, tp, fp):
    """Per-class AUROC over ``(K, C)`` summary columns already sorted and
    unique per class (every compaction's output): cumsums and the
    trapezoid, no sort."""
    return binary_auroc_counts_presorted_kernel(s.T, tp.T, fp.T)


def _mc_auprc_presorted(s, tp, fp):
    return binary_auprc_counts_presorted_kernel(s.T, tp.T, fp.T)


# the exact summary's states, which the score sketch replaces in approx mode
_SUMMARY_CACHES = ("summary_scores", "summary_tp", "summary_fp")


class _CompactingCacheLifecycle:
    """Exact lifecycle of the sample-cache curve metrics: the raw cache, the
    compaction threshold, the cache-row counter every state mutation keeps
    true, the compacted summary, the device-side NaN-sample flag, the
    merge/reset/load hooks and the distributed exact route. Subclasses
    implement :meth:`_compact` and register their states via
    :meth:`_init_compaction`.
    """

    # what one unit of the NaN counter is, for the compute-time error: the
    # binary metrics count samples, the multiclass ones per-class entries
    _NAN_FLAG_NOUN = "sample(s)"

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
        for name in _SUMMARY_CACHES:
            self._add_cache_state(name)
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

    def _presorted_summary(self):
        """``(s, tp, fp)`` when the state is a single summary buffer known to
        be sorted and unique (per class, for ``(K, C)`` columns), else None.
        Raw leftovers give None rather than a forced compaction: feeding
        them to the sorting compute is less work than a compaction followed
        by the presorted compute."""
        if self._compaction_threshold is None:
            return None
        if not self._summary_sorted or self.inputs or len(self.summary_scores) != 1:
            return None
        return self.summary_scores[0], self.summary_tp[0], self.summary_fp[0]

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
                f"{dropped} {self._NAN_FLAG_NOUN} with NaN scores reached "
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

    # ------------------------------------------------- distributed compute
    # the exact metric's kernel in ops/dist_curves.py ("auroc", "auprc",
    # "mc_auroc", "mc_auprc"), set by each metric class
    _DIST_KERNEL: Optional[str] = None

    def _family(self) -> str:
        return "multiclass" if (self._DIST_KERNEL or "").startswith("mc_") else "binary"

    def _empty_block(self):
        """A rank with no cached rows still joins every collective, with
        empty blocks of its metric's shape."""
        classes = getattr(self, "num_classes", None)
        shape = (0,) if self._family() == "binary" else (0, classes)
        return (torch.empty(shape, dtype=torch.float32, device=self._device),
                torch.empty((0,), dtype=torch.int64, device=self._device))

    def _cache_blocks(self):
        empty_s, empty_t = self._empty_block()
        return list(self.inputs) or [empty_s], list(self.targets) or [empty_t]

    def _sharded_raw_mesh(self, group) -> bool:
        """True when the distributed exact curve applies to this metric over
        ``group``: not for a multiclass metric without ``num_classes`` (a
        rank with no rows could not shape its blocks), or a group of one
        rank. Decided from the configuration and the group alone, so every
        rank decides alike; what this rank's cache holds rides the route's
        first collective (:meth:`_sharded_value`)."""
        if self._DIST_KERNEL is None:
            return False
        if self._family() == "multiclass" and getattr(self, "num_classes", None) is None:
            return False
        return _group_size(group) > 1

    def _sharded_value(self, group):
        """The exact value over ``group`` by the distributed curve, or None
        on every rank of it when the route stands down: some rank's cache
        holds summary rows or a NaN flag (its abstention), or a NaN score or
        a bucket overflow tripped the error channel."""
        if not self._sharded_raw_mesh(group):
            return None
        abstain = bool(self.summary_scores) or int(self.summary_nan_dropped.item()) != 0
        s_list, t_list = self._cache_blocks()
        out = curve_value(self._DIST_KERNEL, s_list, t_list, group=group, abstain=abstain)
        if out is None or out[1]:
            return None
        return out[0]

    def _distributed_compute(self, group):
        """``compute()`` over every rank of ``group`` (a process group, or
        a ``DeviceMesh`` dim's ``MeshAxis``) without gathering the samples,
        or None on every rank when no route applies (then the caller syncs
        the metric by gathering). Every rank of ``group`` calls it
        together. The state is read, never changed."""
        value = self._sharded_value(group)
        if value is None:
            return None
        record_call("dist", self._family())
        if self._family() == "multiclass":
            return _mc_average(value, self.average)
        return value


def _group_size(group) -> int:
    return _dist.world_size(_dist.process_group(group))


class _CurveMetric(ScoreSketchCacheMixin, _CompactingCacheLifecycle, SampleCacheMetric[torch.Tensor]):
    """State of the AUROC/AUPRC family: the exact lifecycle, or with
    ``approx=`` the score sketch's (module doc). The sketch's mixin stands
    first, so in approx mode the exact lifecycle never runs."""

    def _init_curve(
        self, compaction_threshold: Optional[int], bits: Optional[int], num_classes=None
    ) -> None:
        self._init_compaction(compaction_threshold)
        if bits is not None:
            self._init_score_sketch(bits, num_classes=num_classes)

    def _init_score_sketch(self, bits: int, *, num_classes: Optional[int] = None) -> None:
        """The sketch takes the exact summary's place in the state (here and
        in ``enable_metric_approx``); a given ``compaction_threshold`` is
        its fold cadence."""
        for name in (*_SUMMARY_CACHES, "summary_nan_dropped"):
            del self._state_name_to_default[name], self._state_name_to_reduction[name]
            delattr(self, name)
        if self._compaction_threshold is not None:
            self._sketch_fold_rows = self._compaction_threshold
        super()._init_score_sketch(bits, num_classes=num_classes)

    def _cache_batch(self, input, target):
        self.inputs.append(input)
        self.targets.append(target)
        if self._sketch_enabled():
            self._score_sketch_stage(input.shape[0])
        else:
            self._count_cached_update(input.shape[0])
        return self

    def _distributed_compute(self, group):
        """The exact routes, or for an approximate metric over more than one
        rank, every rank's resident sketch and staged rows added in one
        int32 all-reduce."""
        if not self._sketch_enabled():
            return super()._distributed_compute(group)
        if _group_size(group) <= 1:
            return None
        s_list, t_list = self._cache_blocks()
        tp, fp, nan = sharded_sketch_counts(
            s_list, t_list, group=group, bucket_bits=self._sketch_bits,
            num_classes=self._sketch_classes,
            base=(self.sketch_tp, self.sketch_fp, self.sketch_nan_dropped),
        )
        record_call("sketch", self._family())
        # the metric's own compute over the global sketch, nothing staged
        view = copy.copy(self)
        view.inputs, view.targets = [], []
        view.sketch_tp, view.sketch_fp, view.sketch_nan_dropped = tp, fp, nan
        return view.compute()


class _BinaryCurveMetric(_CurveMetric):
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

    With ``approx=`` the summary states give way to the resident
    ``sketch_tp``/``sketch_fp`` histograms and ``sketch_nan_dropped``
    (module doc), 2^16 buckets by default.
    """

    def __init__(
        self,
        *,
        compaction_threshold: Optional[int] = None,
        approx=None,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        self._init_curve(
            compaction_threshold, resolve_approx(approx, default_bits=DEFAULT_BUCKET_BITS)
        )

    def update(self, input, target) -> "_BinaryCurveMetric":
        input, target = self._input(input), self._input(target)
        _auroc_update_input_check(input, target)
        return self._cache_batch(input, target)

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
            )
        )

    def _value(self, empty: float, presorted_fn, from_parts, sketch_from_parts):
        if self._sketch_enabled():
            return self._score_sketch_value(sketch_from_parts)
        if not (self.inputs or self.summary_scores):
            return torch.tensor(empty, device=self._device)
        record_call("fused", "binary")
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

    _DIST_KERNEL = "auroc"

    def compute(self) -> torch.Tensor:
        return self._value(
            0.5, binary_auroc_counts_presorted_kernel, _auroc_from_parts, sketch_auroc_from_parts
        )


class BinaryAUPRC(_BinaryCurveMetric):
    """Streaming area under the PR curve (average precision)."""

    _DIST_KERNEL = "auprc"

    def compute(self) -> torch.Tensor:
        return self._value(
            0.0, binary_auprc_counts_presorted_kernel, _auprc_from_parts, sketch_auprc_from_parts
        )


class _MulticlassCurveMetric(_CurveMetric):
    """Cache and compaction machinery of the one-vs-all multiclass curve
    metrics: the raw ``(N, C)`` score and ``(N,)`` label caches, and with
    ``compaction_threshold`` set, per-class exact unique-threshold summaries
    as ``(K, C)`` columns (12 * C bytes a row, K the largest per-class score
    cardinality of the stream, not its sample count)."""

    # one (N, C) row with NaN scores adds one entry per NaN-scored class
    _NAN_FLAG_NOUN = "per-class score entry(ies)"

    def __init__(
        self,
        *,
        num_classes: Optional[int] = None,
        average: Optional[str] = "macro",
        compaction_threshold: Optional[int] = None,
        approx=None,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        _mc_curve_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average
        self._init_curve(
            compaction_threshold,
            resolve_approx(approx, default_bits=DEFAULT_MC_BUCKET_BITS),
            num_classes,
        )

    def update(self, input, target):
        input, target = self._input(input), self._input(target)
        _multiclass_precision_recall_curve_update_input_check(input, target, self.num_classes)
        return self._cache_batch(input, target)

    def _compact(self) -> None:
        """Fold the raw cache and the per-class summaries into one padded
        ``(K, C)`` summary set (one host read, for the adaptive trim)."""
        n = sum(int(a.shape[0]) for a in self.inputs) + sum(
            int(a.shape[0]) for a in self.summary_scores
        )
        if n == 0:
            return
        self._install_compacted(
            *_mc_compact_parts(
                self.inputs,
                self.targets,
                self.summary_scores,
                self.summary_tp,
                self.summary_fp,
                self.summary_nan_dropped,
                _pad_cap(n),
                self.num_classes,
            )
        )

    def _value(self, empty: float, presorted_fn, from_parts, sketch_from_parts):
        if self._sketch_enabled():
            return _mc_average(self._score_sketch_value(sketch_from_parts), self.average)
        if not (self.inputs or self.summary_scores):
            if self.average == "macro":
                return torch.tensor(empty, device=self._device)
            return torch.full((self.num_classes,), empty, device=self._device)
        record_call("fused", "multiclass")
        presorted = self._presorted_summary()
        if presorted is not None:
            per_class = presorted_fn(*presorted)
        else:
            per_class = from_parts(
                self.inputs,
                self.targets,
                self.summary_scores,
                self.summary_tp,
                self.summary_fp,
                self.num_classes,
            )
        self._check_nan_flag()
        return _mc_average(per_class, self.average)


class MulticlassAUROC(_MulticlassCurveMetric):
    """Streaming one-vs-all multiclass AUROC (``average`` "macro", or
    "none"/None for the per-class vector); 0.5 with no data."""

    _DIST_KERNEL = "mc_auroc"

    def compute(self) -> torch.Tensor:
        return self._value(0.5, _mc_auroc_presorted, _mc_auroc_from_parts, sketch_auroc_from_parts)


class MulticlassAUPRC(_MulticlassCurveMetric):
    """Streaming one-vs-all multiclass average precision; 0.0 with no
    data."""

    _DIST_KERNEL = "mc_auprc"

    def compute(self) -> torch.Tensor:
        return self._value(0.0, _mc_auprc_presorted, _mc_auprc_from_parts, sketch_auprc_from_parts)
