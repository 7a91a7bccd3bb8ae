"""Resident-sketch state for the ``approx=`` metric mode.

JAX counterpart: ``torcheval_tpu/sketch/cache.py``, with the sliced
fold's ``shard=`` branch and the per-shard extent bound, without the
sharded sketch counts of ``ops/dist_curves.py``. The glue between the folds and computes
of ``sketch/histogram.py`` and the sample-cache metric classes:

* the knob: the ``approx=`` argument and the ``TORCHEVAL_TPU_APPROX``
  environment variable, the same one the JAX package reads, so one setting
  drives both packages (:func:`resolve_approx`);
* the staged-fold cadence: ``update()`` appends to the raw cache (no device
  work) and the staged rows fold into the resident histograms once they
  reach :data:`SKETCH_FOLD_ROWS` rows (for the compacting curve metrics,
  their ``compaction_threshold``), so memory stays ``O(buckets) +
  O(cadence)`` for any stream length;
* the compute-from-parts functions: a ``compute()`` folds leftover staged
  rows into a temporary histogram and never changes state, so
  ``compute(); compute()`` and ``compute(); update(); compute()`` give what
  a fold at each step would;
* :func:`enable_metric_approx`, which switches a fresh metric into sketch
  mode after construction (``dry_run=True`` validates only);
* the mixins :class:`ScoreSketchCacheMixin` (the precision-recall curves)
  and :class:`ValueSketchCacheMixin` (``HitRate``, ``ReciprocalRank``,
  ``Cat``);
* the sliced collection's sketch helpers (per-cohort ``(tp, fp)``
  histograms folded by one combined-index segment sum).

The registered state is plain: int32 SUM count tensors and an int32 SUM NaN
count, so approx metrics ride ``merge_state`` (adding buckets is the exact
merge), the port's two-round sync as raw bytes, and ``state_dict``.

Each fold of staged rows counts ``sketch.folds{kind=score|mc_score|value}``
and ``sketch.folded_rows{kind=}`` in the obs registry while it is enabled,
as in the JAX package (which counts a fold program's dispatch; here each
fold is one segment-sum launch).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from torcheval_tpu_torch.obs import registry as _obs
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


def _folded_score_parts(raw_s, raw_t, tp, fp, nan_acc, bits):
    """The resident sketch plus any staged leftovers, state untouched."""
    if raw_s:
        return score_fold_parts(raw_s, raw_t, tp, fp, nan_acc, bits)
    return tp, fp, nan_acc


def sketch_auroc_from_parts(raw_s, raw_t, tp, fp, nan_acc, bits):
    tp, fp, nan = _folded_score_parts(raw_s, raw_t, tp, fp, nan_acc, bits)
    return auroc_from_hist(tp, fp, bits), nan, counts_exactness_flag(tp, fp)


def sketch_auprc_from_parts(raw_s, raw_t, tp, fp, nan_acc, bits):
    tp, fp, nan = _folded_score_parts(raw_s, raw_t, tp, fp, nan_acc, bits)
    return auprc_from_hist(tp, fp, bits), nan, counts_exactness_flag(tp, fp)


def sketch_prc_from_parts(raw_s, raw_t, tp, fp, nan_acc, bits):
    tp, fp, nan = _folded_score_parts(raw_s, raw_t, tp, fp, nan_acc, bits)
    precision, recall, nonempty = prc_points_from_hist(tp, fp)
    return precision, recall, nonempty, nan, counts_exactness_flag(tp, fp)


def _folded_mc_parts(raw_s, raw_t, tp, fp, nan_acc, bits, num_classes):
    if raw_s:
        return mc_score_fold_parts(raw_s, raw_t, tp, fp, nan_acc, bits, num_classes)
    return tp, fp, nan_acc


def sketch_mc_auroc_from_parts(raw_s, raw_t, tp, fp, nan_acc, bits, num_classes):
    tp, fp, nan = _folded_mc_parts(raw_s, raw_t, tp, fp, nan_acc, bits, num_classes)
    return auroc_from_hist(tp, fp, bits), nan, counts_exactness_flag(tp, fp)


def sketch_mc_auprc_from_parts(raw_s, raw_t, tp, fp, nan_acc, bits, num_classes):
    tp, fp, nan = _folded_mc_parts(raw_s, raw_t, tp, fp, nan_acc, bits, num_classes)
    return auprc_from_hist(tp, fp, bits), nan, counts_exactness_flag(tp, fp)


def sketch_mc_prc_from_parts(raw_s, raw_t, tp, fp, nan_acc, bits, num_classes):
    tp, fp, nan = _folded_mc_parts(raw_s, raw_t, tp, fp, nan_acc, bits, num_classes)
    precision, recall, nonempty = prc_points_from_hist(tp, fp)
    return precision, recall, nonempty, nan, counts_exactness_flag(tp, fp)


def fold_staged_scores(metric) -> None:
    """Fold a score-sketch metric's staged ``inputs``/``targets`` into its
    resident ``sketch_tp``/``sketch_fp``/``sketch_nan_dropped`` (one
    segment-sum launch, no host read: the sketch's shape is fixed) and
    clear the staging caches. The caller resets its own row counter."""
    if not metric.inputs:
        return
    rows = sum(int(a.shape[0]) for a in metric.inputs)
    state = (metric.sketch_tp, metric.sketch_fp, metric.sketch_nan_dropped, metric._sketch_bits)
    if metric._sketch_classes is None:
        tp, fp, nan = score_fold_parts(metric.inputs, metric.targets, *state)
        _count_fold("score", rows)
    else:
        tp, fp, nan = mc_score_fold_parts(
            metric.inputs, metric.targets, *state, metric._sketch_classes
        )
        _count_fold("mc_score", rows)
    metric.inputs = []
    metric.targets = []
    metric.sketch_tp = tp
    metric.sketch_fp = fp
    metric.sketch_nan_dropped = nan


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


# --------------------------------------------------- shared state registration
def register_score_sketch_states(metric, bits: int, num_classes) -> None:
    """The one definition of the resident score-sketch state: ``sketch_tp``
    and ``sketch_fp`` int32 ``(B,)`` or ``(C, B)``, ``sketch_nan_dropped``
    int32 scalar, all SUM."""
    from torcheval_tpu_torch.metrics.state import Reduction, zeros_state

    shape = (1 << bits,) if num_classes is None else (num_classes, 1 << bits)
    metric._add_state("sketch_tp", zeros_state(shape, dtype=torch.int32), reduction=Reduction.SUM)
    metric._add_state("sketch_fp", zeros_state(shape, dtype=torch.int32), reduction=Reduction.SUM)
    metric._add_state(
        "sketch_nan_dropped", zeros_state((), dtype=torch.int32), reduction=Reduction.SUM
    )


def merge_score_sketch_states(metric, others) -> None:
    """Add other replicas' resident score sketches into ``metric`` (their
    staged rows arrive through the cache merge)."""
    dev = metric.device
    for other in others:
        metric.sketch_tp = metric.sketch_tp + other.sketch_tp.to(dev)
        metric.sketch_fp = metric.sketch_fp + other.sketch_fp.to(dev)
        metric.sketch_nan_dropped = metric.sketch_nan_dropped + other.sketch_nan_dropped.to(dev)


# ------------------------------------------------ switching after construction
def _drop_state(metric, name: str) -> None:
    metric._state_name_to_default.pop(name, None)
    metric._state_name_to_reduction.pop(name, None)
    if hasattr(metric, name):
        delattr(metric, name)


def _require_fresh(metric, *state_names: str) -> None:
    """No streamed data anywhere: raw caches, the cached-sample count or the
    named compacted states (a compacted curve metric has empty raw caches
    while its summary holds every sample)."""
    held = bool(getattr(metric, "inputs", None)) or bool(getattr(metric, "_cached_samples", 0))
    for name in state_names:
        held = held or bool(getattr(metric, name, None))
    if held:
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
    # the compacting curve lifecycle: the exact summary states give way to
    # the resident (tp, fp) histograms
    if hasattr(metric, "_compaction_threshold") and hasattr(metric, "_compact"):
        if metric._sketch_enabled():
            return True
        _require_fresh(metric, "summary_scores", "summary_tp", "summary_fp")
        bits, num_classes = _score_sketch_bits(metric, approx)
        if bits is None or dry_run:
            return True
        for name in ("summary_scores", "summary_tp", "summary_fp", "summary_nan_dropped"):
            _drop_state(metric, name)
        metric._sketch_bits = bits
        metric._sketch_classes = num_classes
        if metric._compaction_threshold is None:
            metric._compaction_threshold = SKETCH_FOLD_ROWS
        register_score_sketch_states(metric, bits, num_classes)
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
        if getattr(metric, cache_name):
            raise ValueError(
                "approx= cannot be applied to a metric that already holds "
                "streamed samples (the registered state schema is part of "
                "checkpoints and sync lanes); construct it with approx= "
                "instead."
            )
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
class ScoreSketchCacheMixin:
    """Approx mode for (score, target) cache metrics without the compaction
    lifecycle (the precision-recall curves): the raw ``inputs``/``targets``
    caches become a staging buffer folded into resident ``(tp, fp)``
    histograms every :data:`SKETCH_FOLD_ROWS` rows. The compacting curve
    metrics (``classification/auroc.py``) fold on their
    ``compaction_threshold`` instead, through the same fold functions."""

    _sketch_bits: Optional[int] = None

    def _init_score_sketch(self, bits: int, *, num_classes: Optional[int] = None) -> None:
        self._sketch_bits = bits
        self._sketch_classes = num_classes
        self._sketch_staged = 0
        register_score_sketch_states(self, bits, num_classes)

    def _sketch_enabled(self) -> bool:
        return self._sketch_bits is not None

    def _score_sketch_stage(self, n_rows: int) -> None:
        self._sketch_staged += n_rows
        if self._sketch_staged >= SKETCH_FOLD_ROWS:
            self._score_sketch_fold()

    def _score_sketch_fold(self) -> None:
        fold_staged_scores(self)
        self._sketch_staged = 0

    def _score_sketch_parts(self):
        """Arguments of the ``sketch_*_from_parts`` computes (state untouched:
        staged leftovers fold inside them)."""
        return (
            list(self.inputs),
            list(self.targets),
            self.sketch_tp,
            self.sketch_fp,
            self.sketch_nan_dropped,
        )

    def _sketch_check_nan(self, nan, noun: str = "sample(s)") -> None:
        raise_sketch_nan(nan, noun)

    def _score_sketch_recount(self) -> None:
        self._sketch_staged = sum(int(a.shape[0]) for a in self.inputs)
        if self._sketch_staged >= SKETCH_FOLD_ROWS:
            self._score_sketch_fold()

    def _sketch_merge_from(self, metrics) -> None:
        merge_score_sketch_states(self, metrics)

    def _prepare_for_merge_state(self) -> None:
        if self._sketch_enabled():
            self._score_sketch_fold()
        super()._prepare_for_merge_state()

    def merge_state(self, metrics):
        metrics = list(metrics)
        super().merge_state(metrics)
        if self._sketch_enabled():
            self._sketch_merge_from(metrics)
            self._score_sketch_recount()
        return self

    def reset(self):
        super().reset()
        if self._sketch_enabled():
            self._sketch_staged = 0
        return self

    def load_state_dict(self, state_dict, strict: bool = True) -> None:
        super().load_state_dict(state_dict, strict)
        if self._sketch_enabled():
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
