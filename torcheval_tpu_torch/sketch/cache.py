"""Resident-sketch state for the ``approx=`` metric mode.

JAX counterpart: ``torcheval_tpu/sketch/cache.py``, with the sliced
fold's ``shard=`` branch and the per-shard extent bound, without the
sharded sketch counts of ``ops/dist_curves.py``. The glue between the folds and computes
of ``sketch/histogram.py`` and the sample-cache metric classes:

* the knob: the ``approx=`` argument and the ``TORCHEVAL_TPU_APPROX``
  environment variable, the same one the JAX package reads, so one setting
  drives both packages (:func:`resolve_approx`);
* :class:`ScoreSketchCacheMixin`, the one lifecycle of every score-sketch
  metric (``BinaryAUROC``, ``BinaryAUPRC``, ``MulticlassAUROC``,
  ``MulticlassAUPRC`` and the precision-recall curves): ``update()``
  appends to the raw cache (no device work) and the staged rows fold into
  the resident histograms once they reach :data:`SKETCH_FOLD_ROWS` rows (or
  an AUROC/AUPRC's ``compaction_threshold``, when the caller gave one), so
  memory stays ``O(buckets) + O(cadence)`` for any stream length; a
  ``compute()`` folds leftover staged rows into a temporary histogram and
  never changes state, so ``compute(); compute()`` and ``compute();
  update(); compute()`` give what a fold at each step would;
* :class:`ValueSketchCacheMixin`, the same for ``HitRate``,
  ``ReciprocalRank`` and ``Cat``;
* :func:`enable_metric_approx`, which switches a fresh metric into sketch
  mode after construction (``dry_run=True`` validates only);
* the sliced collection's sketch helpers (per-cohort ``(tp, fp)``
  histograms folded by one combined-index segment sum).

The registered state is plain: int32 SUM count tensors and an int32 SUM NaN
count, so approx metrics ride ``merge_state`` (adding buckets is the exact
merge), the port's two-round sync as raw bytes, and ``state_dict``.

Each fold of staged rows counts ``sketch.folds{kind=score|mc_score|value}``
and ``sketch.folded_rows{kind=}`` in the obs registry while it is enabled,
as in the JAX package (which counts a fold program's dispatch; here each
fold is one segment-sum launch). A score fold, the update's and a
compute's fold of leftovers alike, runs inside a ``metric.fold/<Class>``
span (``kind=score|mc_score``) and a profiler range of that name, so its
bucket keys, lanes and segment sum are timed apart from the rest of the
update or compute; with obs off that costs one module-global read.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from torcheval_tpu_torch.obs import registry as _obs
from torcheval_tpu_torch.obs.annotate import spanned
from torcheval_tpu_torch.ops.curves import (
    binary_auprc_counts_presorted_kernel,
    binary_auroc_counts_presorted_kernel,
)
from torcheval_tpu_torch.ops.scatter import segment_sum
from torcheval_tpu_torch.sketch.buckets import (
    DEFAULT_BUCKET_BITS,
    DEFAULT_MC_BUCKET_BITS,
    MAX_BUCKET_BITS,
    MIN_BUCKET_BITS,
    bucket_index,
    check_bucket_bits,
    representatives_on,
)
from torcheval_tpu_torch.sketch.histogram import (
    auprc_from_hist,
    auroc_from_hist,
    counts_exactness_flag,
    mc_score_hist_fold,
    prc_points_from_hist,
    score_hist_fold,
    value_hist_fold,
)

# staged rows per fold: memory is O(buckets) + O(SKETCH_FOLD_ROWS)
SKETCH_FOLD_ROWS = 65536

_APPROX_ENV = "TORCHEVAL_TPU_APPROX"


def resolve_approx(approx, *, default_bits: int = DEFAULT_BUCKET_BITS) -> Optional[int]:
    """The ``approx=`` knob as ``bucket_bits``, or ``None`` for exact.

    ``None`` defers to ``TORCHEVAL_TPU_APPROX`` (unset or ``0`` off, ``1``
    on with the family default, an integer a bucket count); ``False`` is
    exact even with the variable set; ``True`` the family default; an int a
    bucket count, a power of two."""
    if approx is None:
        env = os.environ.get(_APPROX_ENV, "0").strip().lower()
        if env in ("", "0", "false", "off"):
            return None
        if env in ("1", "true", "on"):
            return default_bits
        try:
            approx = int(env)
        except ValueError:
            raise ValueError(
                f"{_APPROX_ENV} must be 0/1/true/false or a bucket count, got {env!r}."
            ) from None
    if approx is False:
        return None
    if approx is True:
        return default_bits
    count = int(approx)
    bits = count.bit_length() - 1
    if count <= 0 or (1 << bits) != count:
        raise ValueError(f"approx bucket count must be a power of two, got {count}.")
    return check_bucket_bits(bits)


def _count_fold(kind: str, rows: int) -> None:
    if _obs._enabled:
        _obs.counter("sketch.folds", kind=kind)
        _obs.counter("sketch.folded_rows", float(rows), kind=kind)


def _cat(parts, dim: int = 0) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


# ------------------------------------------------------ fold/compute parts
def score_fold_parts(raw_s, raw_t, tp, fp, nan_acc, bits):
    """Fold staged binary batches into the resident ``(tp, fp)`` sketch."""
    dtp, dfp, nan = score_hist_fold(_cat(raw_s), _cat(raw_t), bits)
    return tp + dtp, fp + dfp, nan_acc + nan


def mc_score_fold_parts(raw_s, raw_t, tp, fp, nan_acc, bits, num_classes):
    dtp, dfp, nan = mc_score_hist_fold(_cat(raw_s), _cat(raw_t), bits, num_classes)
    return tp + dtp, fp + dfp, nan_acc + nan


def value_fold_parts(cache, counts, nan_acc, bits):
    """Fold staged value batches into the resident count sketch."""
    dc, nan = value_hist_fold(_cat([c.reshape(-1) for c in cache]), bits)
    return counts + dc, nan_acc + nan


def sketch_auroc_from_parts(tp, fp, nan, bits):
    return auroc_from_hist(tp, fp, bits), nan, counts_exactness_flag(tp, fp)


def sketch_auprc_from_parts(tp, fp, nan, bits):
    return auprc_from_hist(tp, fp, bits), nan, counts_exactness_flag(tp, fp)


def sketch_prc_from_parts(tp, fp, nan, bits):
    precision, recall, nonempty = prc_points_from_hist(tp, fp)
    return precision, recall, nonempty, nan, counts_exactness_flag(tp, fp)


def _score_kind(metric) -> str:
    return "score" if metric._sketch_classes is None else "mc_score"


def _fold_parts(metric, raw_s, raw_t):
    """The staged rows ``raw_s``/``raw_t`` folded into the metric's resident
    sketch: ``(tp, fp, nan)``, state untouched (one segment-sum launch)."""
    state = (metric.sketch_tp, metric.sketch_fp, metric.sketch_nan_dropped, metric._sketch_bits)
    if metric._sketch_classes is None:
        return score_fold_parts(raw_s, raw_t, *state)
    return mc_score_fold_parts(raw_s, raw_t, *state, metric._sketch_classes)


def _spanned_fold(metric, raw_s, raw_t):
    """:func:`_fold_parts`, inside a ``metric.fold/<Class>`` span labelled
    ``kind=`` while obs is enabled."""
    if not _obs._enabled:
        return _fold_parts(metric, raw_s, raw_t)
    name = f"metric.fold/{type(metric).__name__}"
    return spanned(name, {"kind": _score_kind(metric)}, _fold_parts, metric, raw_s, raw_t)


def folded_sketch_parts(metric):
    """``(tp, fp, nan)``: the resident sketch plus the staged leftovers,
    folded inside the ``metric.fold/<Class>`` span; state untouched, so a
    ``compute()`` stays idempotent."""
    if not metric.inputs:
        return metric.sketch_tp, metric.sketch_fp, metric.sketch_nan_dropped
    return _spanned_fold(metric, metric.inputs, metric.targets)


def value_counts_from_parts(cache, counts, nan_acc, bits):
    if cache:
        counts, nan_acc = value_fold_parts(cache, counts, nan_acc, bits)
    return counts, nan_acc, counts_exactness_flag(counts)


# ------------------------------------------------------ shared loud failures
def raise_sketch_nan(nan, noun: str = "value(s)") -> None:
    """The loud-NaN contract: one scalar host read."""
    dropped = int(nan)
    if dropped:
        raise ValueError(
            f"{dropped} {noun} with NaN scores reached the sketch; NaN "
            "has no order and cannot be bucketed (the exact kernels "
            "would count them). Filter NaNs before update() or use "
            "approx=False."
        )


def raise_sketch_overflow(flag) -> None:
    """Raise when :func:`histogram.counts_exactness_flag` tripped: past
    about 2.1e9 samples in one sketch (or a wrapped bucket) the int32
    cumulative sums of the computes would wrap."""
    if bool(flag):
        raise ValueError(
            "sketch count state exceeded the int32-exact range (~2.1e9 "
            "total samples per sketch, or a wrapped bucket): curve and "
            "quantile computes would silently wrap. Reset or split the "
            "stream across replicas (sketch merges are exact) before a "
            "single sketch accumulates 2^31 samples."
        )


# ------------------------------------------------ switching after construction
def _require_fresh(metric) -> None:
    """No streamed data: every cache state empty (a compacted curve metric
    has empty raw caches while its summary caches hold every sample)."""
    if any(getattr(metric, name) for name in metric._cache_names()):
        raise ValueError(
            "approx= cannot be applied to a metric that already holds "
            "streamed samples (the registered state schema is part of "
            "checkpoints and sync lanes); construct it with approx= "
            "instead."
        )


def _score_sketch_bits(metric, approx):
    num_classes = getattr(metric, "num_classes", None)
    is_mc = hasattr(metric, "num_classes")
    if is_mc and num_classes is None:
        raise ValueError(
            "approx= needs num_classes on the multiclass curve metrics "
            "(the (C, buckets) sketch state cannot be sized without it)."
        )
    bits = resolve_approx(
        approx, default_bits=DEFAULT_MC_BUCKET_BITS if is_mc else DEFAULT_BUCKET_BITS
    )
    return bits, num_classes


def enable_metric_approx(metric, approx, *, dry_run: bool = False) -> bool:
    """Switch a fresh approx-capable metric into sketch mode after
    construction, registering the state its constructor's ``approx=`` would
    have. Returns ``True`` when the metric's class has an approx mode (or
    is a sketch already, ``Quantile``) and ``False`` when it has none.
    Raises ``ValueError`` when this instance cannot switch: it holds
    streamed samples, or its configuration cannot size the sketch
    (``Cat(dim != 0)``, a multiclass curve without ``num_classes``).
    ``dry_run=True`` runs every check and changes nothing. ``approx=None``
    or ``False`` is a no-op."""
    if approx is None or approx is False:
        return True
    if getattr(metric, "_always_approx", False):
        return True
    if isinstance(metric, ScoreSketchCacheMixin):
        if metric._sketch_enabled():
            return True
        _require_fresh(metric)
        bits, num_classes = _score_sketch_bits(metric, approx)
        if bits is not None and not dry_run:
            metric._init_score_sketch(bits, num_classes=num_classes)
        return True
    if isinstance(metric, ValueSketchCacheMixin):
        if metric._sketch_enabled():
            return True
        cache_name = "scores" if hasattr(metric, "scores") else "inputs"
        if getattr(metric, "dim", 0) != 0:
            raise ValueError(
                "approx= requires dim=0: the sketch pools elements and "
                "cannot represent higher-dimension concat structure."
            )
        _require_fresh(metric)
        bits = resolve_approx(approx, default_bits=DEFAULT_BUCKET_BITS)
        if bits is not None and not dry_run:
            metric._init_value_sketch(bits, cache_name)
        return True
    return False


# ----------------------------------------------------------- sliced sketches
# Per-cohort score sketches of the sliced collection: every cohort keeps its
# own (tp, fp) histogram, folded by one combined-index segment sum
# (row * planes + plane), so the scratch is O(batch), not O(batch x buckets).
# Sliced widths may go below the standalone 10-bit floor: a per-cohort AUROC
# or AUPRC needs only the bucket order (the curve functions never read the
# representatives), and at a million cohorts each bit doubles the state.
# The a-posteriori error bounds hold at any width.
SLICED_MIN_BUCKET_BITS = 4


def check_sliced_bucket_bits(bucket_bits: int) -> int:
    if (
        not isinstance(bucket_bits, int)
        or not SLICED_MIN_BUCKET_BITS <= bucket_bits <= MAX_BUCKET_BITS
    ):
        raise ValueError(
            "sliced curve_bucket_bits must be an int in "
            f"[{SLICED_MIN_BUCKET_BITS}, {MAX_BUCKET_BITS}], got {bucket_bits!r}."
        )
    return bucket_bits


def check_sliced_sketch_extent(bucket_bits: int, num_slices: int, shards: int = 1) -> None:
    """Fail closed at the sliced sketch's addressing edge: the combined
    segment index ``row * planes + plane`` is int32, so the per-shard
    extent ``ceil(num_slices / shards) * (2^(bits+1) + 1)`` must stay at
    most 2^31 - 1, past which the index would wrap and corrupt per-cohort
    counts. Run at member registration and at every capacity growth, never
    inside the fold. The bound is per shard because a sharded fold builds
    each rank's index over its own tile: sharding over N ranks multiplies
    the cohorts a width admits by N. 16-bit buckets cap out near 16,000
    cohorts a shard; a million cohorts need ``curve_bucket_bits`` of 4-10
    or a sharded slice axis."""
    planes = 2 * (1 << bucket_bits) + 1
    shards = max(int(shards), 1)
    per_shard = -(-int(num_slices) // shards)
    if per_shard * planes > 2**31 - 1:
        raise ValueError(
            f"sliced sketch extent {per_shard} slices/shard x {planes} planes "
            f"(curve_bucket_bits={bucket_bits}, {num_slices} slices over {shards} "
            "shard(s)) exceeds the int32 segment-index range (2^31-1): per-slice "
            "histogram counts would silently corrupt. Use a coarser curve_bucket_bits "
            "(each bit halves the slice headroom) or shard the slice axis over more "
            "ranks (SlicedMetricCollection(mesh=..., mesh_axis=...)): the extent bound "
            "is per shard."
        )


def sliced_score_hist_fold(rows, scores, targets, bits, num_slices, shard=None):
    """Fold one ``(N,)`` binary batch into per-cohort ``(num_slices, B)``
    ``(tp, fp)`` int32 histograms and a per-cohort NaN count, routed by the
    dense ``rows`` column. Each sample lands in plane ``2 * bucket + (1 -
    target)`` of its cohort's ``2B + 1`` planes (NaN samples in the last),
    so the fold is one segment-sum launch of int32 ones however many count
    lanes the sketch keeps. Integer adds: per-cohort counts equal those of a
    standalone fold of the cohort's samples.

    With ``shard`` (the slice axis's ``utils.dist.MeshAxis``), rank ``r`` of
    ``S`` folds into its tile of ``w = num_slices / S`` cohorts: the rows
    are localised to ``rows - r*w`` before the combined index is built (a
    global index would wrap int32 at the unsharded edge), and a sample of
    another rank's tile goes to index -1, which the segment sum drops."""
    check_sliced_bucket_bits(bits)
    rows = rows.to(torch.int32)
    nan = torch.isnan(scores.to(torch.float32))
    t = targets.to(torch.int32)
    b = bucket_index(scores, bits)
    num_buckets = 1 << bits
    planes = 2 * num_buckets + 1
    plane = torch.where(nan, 2 * num_buckets, 2 * b + (1 - t))
    if shard is None:
        idx = rows * planes + plane
    else:
        num_slices //= shard.size
        local = rows - shard.rank * num_slices
        ok = (local >= 0) & (local < num_slices)
        idx = torch.where(ok, local * planes + plane, -1)
    hist = segment_sum(torch.ones_like(rows), idx, num_slices * planes).reshape(num_slices, planes)
    return {
        "sketch_tp": hist[:, 0 : 2 * num_buckets : 2],
        "sketch_fp": hist[:, 1 : 2 * num_buckets : 2],
        "sketch_nan_dropped": hist[:, 2 * num_buckets],
    }


def sliced_curve_values(tp, fp, bits, kind):
    """Per-cohort curve values of ``(S, B)`` sketches: the presorted counts
    function the standalone sketch metrics compute with, along the last
    axis. Below the standalone bucket floor the score row is zeros: the
    counts functions read it for its shape only."""
    fn = (
        binary_auroc_counts_presorted_kernel
        if kind == "auroc"
        else binary_auprc_counts_presorted_kernel
    )
    if bits >= MIN_BUCKET_BITS:
        reps = representatives_on(bits, tp.device, descending=True)
    else:
        reps = torch.zeros(1 << bits, dtype=torch.float32, device=tp.device)
    return fn(reps, tp.flip(-1), fp.flip(-1))


def sliced_curve_compute(tp, fp, nan, _hi, _lo, _count, bits, kind):
    """The sliced score-sketch member's ``_compute_fn`` (the id lanes follow
    the sketch states and are ignored): ``(per-cohort values, exactness
    flag, NaN total)``; the member's ``_on_window_result`` raises on the
    flags and wraps the values."""
    return sliced_curve_values(tp, fp, bits, kind), counts_exactness_flag(tp, fp), torch.sum(nan)


# ------------------------------------------------------- score-sketch mixin
def _cache_base():
    # the metrics import this module, so their cache base is looked up late
    from torcheval_tpu_torch.metrics.sample_cache import SampleCacheMetric

    return SampleCacheMetric


class ScoreSketchCacheMixin:
    """Approx mode for the (score, target) sample-cache metrics: the
    AUROC/AUPRC family and the precision-recall curves. The raw
    ``inputs``/``targets`` caches become a staging buffer, counted in
    ``_sketch_staged`` and folded into resident ``sketch_tp``/``sketch_fp``
    int32 ``(B,)`` or ``(C, B)`` histograms and a ``sketch_nan_dropped``
    count, all SUM, every ``_sketch_fold_rows`` rows
    (:data:`SKETCH_FOLD_ROWS`; an AUROC/AUPRC given ``compaction_threshold``
    sets its own). A merge adds the replicas' buckets, and a merge or a load
    recounts the staged rows.

    It stands first among a metric's bases. With the sketch on, each
    lifecycle hook here is the whole lifecycle over the cache base, past
    any exact-mode lifecycle the metric also has; with it off, each hook is
    the next base's."""

    _sketch_bits: Optional[int] = None
    _sketch_fold_rows: int = SKETCH_FOLD_ROWS

    def _init_score_sketch(self, bits: int, *, num_classes: Optional[int] = None) -> None:
        from torcheval_tpu_torch.metrics.state import Reduction, zeros_state

        self._sketch_bits = bits
        self._sketch_classes = num_classes
        self._sketch_staged = 0
        shape = (1 << bits,) if num_classes is None else (num_classes, 1 << bits)
        for name in ("sketch_tp", "sketch_fp"):
            self._add_state(name, zeros_state(shape, dtype=torch.int32), reduction=Reduction.SUM)
        self._add_state(
            "sketch_nan_dropped", zeros_state((), dtype=torch.int32), reduction=Reduction.SUM
        )

    def _sketch_enabled(self) -> bool:
        return self._sketch_bits is not None

    def _score_sketch_stage(self, n_rows: int) -> None:
        self._sketch_staged += n_rows
        if self._sketch_staged >= self._sketch_fold_rows:
            self._score_sketch_fold()

    def _score_sketch_fold(self) -> None:
        """Fold the staged rows into the resident sketch (one segment-sum
        launch, no host read: the sketch's shape is fixed) and clear the
        staging caches."""
        if self.inputs:
            rows = sum(int(a.shape[0]) for a in self.inputs)
            tp, fp, nan = _spanned_fold(self, self.inputs, self.targets)
            _count_fold(_score_kind(self), rows)
            self.inputs = []
            self.targets = []
            self.sketch_tp, self.sketch_fp, self.sketch_nan_dropped = tp, fp, nan
        self._sketch_staged = 0

    def _score_sketch_recount(self) -> None:
        self._sketch_staged = sum(int(a.shape[0]) for a in self.inputs)
        if self._sketch_staged >= self._sketch_fold_rows:
            self._score_sketch_fold()

    def _score_sketch_value(self, from_parts):
        """``from_parts`` over the resident sketch plus the staged leftovers
        (state untouched, so ``compute()`` stays idempotent), then the
        overflow and NaN checks, one host read each. Returns the value, or
        the tuple of values, before the NaN count and the overflow flag."""
        *value, nan, overflow = from_parts(*folded_sketch_parts(self), self._sketch_bits)
        raise_sketch_overflow(overflow)
        raise_sketch_nan(
            nan, "sample(s)" if self._sketch_classes is None else "per-class score entry(ies)"
        )
        return value[0] if len(value) == 1 else tuple(value)

    def _prepare_for_merge_state(self) -> None:
        if not self._sketch_enabled():
            return super()._prepare_for_merge_state()
        # a sync ships the bounded sketch, never the staged rows
        self._score_sketch_fold()
        _cache_base()._prepare_for_merge_state(self)

    def merge_state(self, metrics):
        if not self._sketch_enabled():
            return super().merge_state(metrics)
        metrics = list(metrics)
        _cache_base().merge_state(self, metrics)  # the staged rows
        dev = self.device
        for other in metrics:
            self.sketch_tp = self.sketch_tp + other.sketch_tp.to(dev)
            self.sketch_fp = self.sketch_fp + other.sketch_fp.to(dev)
            self.sketch_nan_dropped = self.sketch_nan_dropped + other.sketch_nan_dropped.to(dev)
        self._score_sketch_recount()
        return self

    def reset(self):
        if not self._sketch_enabled():
            return super().reset()
        _cache_base().reset(self)
        self._sketch_staged = 0
        return self

    def load_state_dict(self, state_dict, strict: bool = True) -> None:
        if not self._sketch_enabled():
            return super().load_state_dict(state_dict, strict)
        _cache_base().load_state_dict(self, state_dict, strict)
        self._score_sketch_recount()


# ------------------------------------------------------- value-sketch mixin
class ValueSketchCacheMixin:
    """Approx mode for value-cache metrics (``HitRate``, ``ReciprocalRank``,
    ``Cat``): the per-sample cache becomes a staging buffer folded into a
    resident bucket-count sketch every :data:`SKETCH_FOLD_ROWS` values.
    ``Cat``, whose merge is its own, calls the ``_sketch_*`` helpers."""

    _sketch_bits: Optional[int] = None

    def _init_value_sketch(self, bits: int, cache_name: str) -> None:
        from torcheval_tpu_torch.metrics.state import Reduction, zeros_state

        self._sketch_bits = bits
        self._sketch_cache_name = cache_name
        self._sketch_staged = 0
        self._add_state(
            "sketch_counts", zeros_state((1 << bits,), dtype=torch.int32), reduction=Reduction.SUM
        )
        self._add_state(
            "sketch_nan_dropped", zeros_state((), dtype=torch.int32), reduction=Reduction.SUM
        )

    def _sketch_enabled(self) -> bool:
        return self._sketch_bits is not None

    def _sketch_stage(self, arr: torch.Tensor) -> None:
        """Count freshly appended staging values; fold at the cadence."""
        self._sketch_staged += int(arr.numel()) if arr.ndim else 1
        if self._sketch_staged >= SKETCH_FOLD_ROWS:
            self._sketch_fold()

    def _sketch_fold(self) -> None:
        cache = getattr(self, self._sketch_cache_name)
        if cache:
            counts, nan = value_fold_parts(
                list(cache), self.sketch_counts, self.sketch_nan_dropped, self._sketch_bits
            )
            _count_fold("value", self._sketch_staged)
            setattr(self, self._sketch_cache_name, [])
            self.sketch_counts = counts
            self.sketch_nan_dropped = nan
        self._sketch_staged = 0

    def _sketch_counts_parts(self):
        """``(counts, nan, overflow flag)`` with staged leftovers folded in,
        state untouched."""
        cache = getattr(self, self._sketch_cache_name)
        return value_counts_from_parts(
            list(cache), self.sketch_counts, self.sketch_nan_dropped, self._sketch_bits
        )

    def _sketch_check_nan(self, nan) -> None:
        raise_sketch_nan(nan)

    def _sketch_recount(self) -> None:
        cache = getattr(self, self._sketch_cache_name)
        self._sketch_staged = sum(int(a.numel()) for a in cache)
        if self._sketch_staged >= SKETCH_FOLD_ROWS:
            self._sketch_fold()

    def _sketch_merge_from(self, metrics) -> None:
        """Add other replicas' resident sketches (their staged values arrive
        through the cache merge; the recount after it folds past the
        cadence)."""
        dev = self.device
        for metric in metrics:
            self.sketch_counts = self.sketch_counts + metric.sketch_counts.to(dev)
            self.sketch_nan_dropped = self.sketch_nan_dropped + metric.sketch_nan_dropped.to(dev)

    def _prepare_for_merge_state(self) -> None:
        if self._sketch_enabled():
            # a sync ships the bounded sketch, never the staged values
            self._sketch_fold()
        super()._prepare_for_merge_state()

    def merge_state(self, metrics):
        metrics = list(metrics)
        super().merge_state(metrics)
        if self._sketch_enabled():
            self._sketch_merge_from(metrics)
            self._sketch_recount()
        return self

    def reset(self):
        super().reset()
        if self._sketch_enabled():
            self._sketch_staged = 0
        return self

    def load_state_dict(self, state_dict, strict: bool = True) -> None:
        super().load_state_dict(state_dict, strict)
        if self._sketch_enabled():
            self._sketch_recount()
