"""Host-side observability registry: named counters, gauges, histograms and
span timers.

JAX counterpart: ``torcheval_tpu/obs/registry.py``, ported whole: the same
instrument names, label keys, log2 bucket edges and ``snapshot()`` layout,
so that a snapshot taken in either package compares key for key with one
taken in the other. The library reports into ONE process-wide
:class:`Registry` (``default_registry``); in the port the checkpoint layer
(``resilience/snapshot.py``) and the fault-injection hooks
(``resilience/chaos.py``) report here.

Design constraints, in order:

* **Zero overhead while disabled.** Instrumented call sites gate on
  :func:`enabled`, a single module-global read, and do nothing else: no
  objects are allocated, no locks taken, no strings formatted.
* **Thread-safe.** One registry lock serialises structural mutation, and
  span nesting state is thread-local.
* **Host-side only.** Counters hold Python numbers: host wall time, call
  counts and byte volumes. Device time is the profiler's (``torch.profiler``
  or CUDA events), never the registry's.

Instruments:

* **Counter**: monotone accumulator (``inc``).
* **Gauge**: last-written value (``set``).
* **Histogram**: fixed log2-bucket distribution (``record``): O(buckets)
  memory forever, mergeable across ranks by bucket summation (every process
  shares the same static edges), p50/p95/p99 in ``snapshot()``.
* **Span timer**: aggregated wall-time statistics per span *path*. Spans
  nest: a span opened while another is active on the same thread records
  under ``"outer/inner"``. Each span path also feeds a log2 latency
  histogram, so ``snapshot()`` reports percentiles.

All instruments key on ``(name, labels)``, where labels are an optional
small dict (the Prometheus label model). Distinct label sets per name are
capped (:func:`set_label_cardinality_cap`); past the cap new label sets are
dropped and counted in ``obs.labels.dropped{instrument=}``. Spans recorded
on the default registry also feed the event timeline ring
(``obs/trace.py``) through a module-level sink.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from torcheval_tpu_torch.utils.telemetry import log_once

# Module-level enable flag. Read directly (`if not _enabled: return`) by the
# instrumentation helpers; mutate only through enable()/disable() so future
# hooks (e.g. starting a profiler server) have one choke point.
_enabled: bool = False


def enabled() -> bool:
    """True when observability collection is on (one global read)."""
    return _enabled


def enable() -> None:
    """Turn on registry collection and span recording."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Turn off collection. Already-recorded values are kept (snapshot them
    first if needed); instrumented call sites revert to the no-op path."""
    global _enabled
    _enabled = False


_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# ---------------------------------------------------------- label cardinality
# Per-instrument-name cap on DISTINCT label sets. The
# registry holds every (name, labels) series forever — per-tenant labels
# under churn (thousands of tenants over a daemon's lifetime) would grow the
# maps without bound, and per-SLICE labels (millions of cohorts) would be a
# memory bomb: slice results flow through compute(), never through obs
# labels. Past the cap, NEW label sets for a name are dropped (existing
# series keep recording), counted into ``obs.labels.dropped{instrument=}`` and
# warned once per name through ``utils/telemetry.py::log_once`` (re-armed
# by ``obs.reset()``): loud, bounded, and impossible to mistake for data.
_LABEL_SETS_CAP = 1024
_DROPPED_NAME = "obs.labels.dropped"


def set_label_cardinality_cap(cap: int) -> int:
    """Set the per-name distinct-label-set cap (returns the previous one).
    Applies to series CREATION: lowering the cap does not evict existing
    series. Test hook + escape hatch for unusually wide fleets."""
    global _LABEL_SETS_CAP
    if not isinstance(cap, int) or cap < 1:
        raise ValueError(f"label cardinality cap must be an int >= 1, got {cap!r}.")
    prev = _LABEL_SETS_CAP
    _LABEL_SETS_CAP = cap
    return prev


def format_key(name: str, labels: _LabelKey) -> str:
    """``name`` or ``name{k=v,...}`` — the snapshot-key spelling shared by
    :meth:`Registry.snapshot` and the JAX package's cross-rank merge,
    so local and cluster views correlate 1:1."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


# Sink wired by ``obs/trace.py`` at import: spans recorded on the DEFAULT
# registry (the only one the library reports into) are mirrored into the
# event timeline ring as complete events. Signature:
# ``(path, labels, t0_perf_counter, seconds, parent_path_or_None) -> None``.
_span_sink: Optional[Callable[[str, _LabelKey, float, float, Optional[str]], None]] = None


# ------------------------------------------------------- histogram buckets
# One static log2 bucket scheme for every histogram in the process (and the
# fleet: merging across ranks is bucket summation ONLY because the edges are
# compile-time constants, never data-dependent). Bucket ``i`` counts values
# in ``(2^(MIN_EXP+i), 2^(MIN_EXP+i+1)]``; the range spans ~7.5e-9 (under
# any measurable host latency in seconds) to ~1.4e11 (covers byte sizes and
# chunk counts too). O(buckets) memory per series, forever.
HISTOGRAM_MIN_EXP = -27
HISTOGRAM_BUCKETS = 64


def bucket_index(value: float) -> int:
    """Fixed log2 bucket for ``value`` (<=0 and NaN clamp to the first
    bucket, +inf to the last — ``math.frexp`` reports exponent 0 for
    non-finite input, which would otherwise mis-bucket them mid-range)."""
    if value <= 0.0 or value != value:
        return 0
    if value == math.inf:
        return HISTOGRAM_BUCKETS - 1
    m, e = math.frexp(value)  # value = m * 2^e, 0.5 <= m < 1
    # value in (2^(e-1), 2^e] -> upper edge 2^e, except the exact power of
    # two 2^(e-1) (m == 0.5), which belongs UNDER its own edge so the
    # Prometheus cumulative-le contract (count of values <= le) holds
    idx = e - 1 - HISTOGRAM_MIN_EXP
    if m == 0.5:
        idx -= 1
    if idx < 0:
        return 0
    if idx >= HISTOGRAM_BUCKETS:
        return HISTOGRAM_BUCKETS - 1
    return idx


def bucket_upper_edge(i: int) -> float:
    """Inclusive upper bound of bucket ``i``."""
    return 2.0 ** (HISTOGRAM_MIN_EXP + i + 1)


def percentile_from_buckets(
    buckets, count: int, q: float
) -> float:
    """Estimate the ``q``-quantile (0..1) from log2 bucket counts by linear
    interpolation inside the containing bucket. Shared by local snapshots
    and the cross-rank merge (bucket-summed histograms keep the same
    estimator)."""
    if count <= 0:
        return 0.0
    target = q * count
    cum = 0.0
    for i, c in enumerate(buckets):
        if not c:
            continue
        if cum + c >= target:
            lower = bucket_upper_edge(i - 1) if i > 0 else 0.0
            upper = bucket_upper_edge(i)
            frac = (target - cum) / c
            return lower + frac * (upper - lower)
        cum += c
    return bucket_upper_edge(HISTOGRAM_BUCKETS - 1)


class Histogram:
    """Fixed-edge log2 histogram: O(buckets) memory, mergeable by bucket
    summation (identical static edges on every process)."""

    __slots__ = ("buckets", "count", "sum")

    def __init__(self) -> None:
        self.buckets: List[int] = [0] * HISTOGRAM_BUCKETS
        self.count = 0
        self.sum = 0.0

    def record(self, value: float) -> None:
        self.buckets[bucket_index(value)] += 1
        self.count += 1
        # a single inf/NaN observation must not poison the series' _sum
        # forever (Prometheus _sum lines and cross-rank merges both
        # propagate it); the clamped bucket above still counts the event
        if math.isfinite(value):
            self.sum += value

    def percentile(self, q: float) -> float:
        return percentile_from_buckets(self.buckets, self.count, q)


class Counter:
    """Monotone accumulator. ``inc`` must never be fed negative deltas."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, delta: float = 1.0) -> None:
        if delta < 0:
            raise ValueError(f"counter increments must be >= 0, got {delta}.")
        self.value += delta


class Gauge:
    """Last-written value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class SpanStats:
    """Aggregated wall-time statistics for one span path, plus the log2
    latency buckets behind the snapshot's p50/p95/p99."""

    __slots__ = ("count", "total_seconds", "max_seconds", "buckets")

    def __init__(self) -> None:
        self.count = 0
        self.total_seconds = 0.0
        self.max_seconds = 0.0
        self.buckets: List[int] = [0] * HISTOGRAM_BUCKETS

    def record(self, seconds: float) -> None:
        self.count += 1
        self.total_seconds += seconds
        if seconds > self.max_seconds:
            self.max_seconds = seconds
        self.buckets[bucket_index(seconds)] += 1


class _Span:
    """Context manager for one span instance; see :meth:`Registry.span`."""

    __slots__ = ("_registry", "_name", "_labels", "_path", "_parent", "_t0")

    def __init__(self, registry: "Registry", name: str, labels: _LabelKey):
        self._registry = registry
        self._name = name
        self._labels = labels
        self._path = None
        self._parent = None
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        # the clock first: a profiler range entered just before lines up
        self._t0 = time.perf_counter()
        stack = self._registry._span_stack()
        if stack:
            self._parent = stack[-1]
            self._path = f"{self._parent}/{self._name}"
        else:
            self._path = self._name
        stack.append(self._path)
        return self

    def __exit__(self, *exc) -> None:
        seconds = time.perf_counter() - self._t0
        stack = self._registry._span_stack()
        # pop OUR frame even if an inner span leaked (exception safety)
        while stack and stack[-1] != self._path:
            stack.pop()
        if stack:
            stack.pop()
        self._registry._record_span(
            self._path, self._labels, seconds, t0=self._t0, parent=self._parent
        )


class DeltaCursor:
    """Opaque position token for :meth:`Registry.delta_since`.

    Holds the generation the registry was in when the cursor was issued, a
    strictly-increasing sequence number (monotonic even across
    :meth:`Registry.reset` — a reset bumps the generation, never rewinds the
    sequence), and the per-series baseline values the next delta diffs
    against. The baseline lives here, not in the registry: the registry has
    no per-key dirty tracking and must not grow per-subscriber state."""

    __slots__ = ("gen", "seq", "base")

    def __init__(self, gen: int, seq: int, base: Dict[tuple, Any]) -> None:
        self.gen = gen
        self.seq = seq
        self.base = base


class Registry:
    """Thread-safe collection of counters, gauges and span timers."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, _LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, _LabelKey], Gauge] = {}
        self._histos: Dict[Tuple[str, _LabelKey], Histogram] = {}
        self._spans: Dict[Tuple[str, _LabelKey], SpanStats] = {}
        # distinct LABELED series created per instrument name, across all
        # instrument kinds — the label-cardinality guard's admission count
        self._label_sets: Dict[str, int] = {}
        # bumped by reset(); lets delta_since detect a cursor issued against
        # state that no longer exists and answer with a full diff instead of
        # a nonsensical (negative-counter) incremental one
        self._generation = 0
        self._local = threading.local()

    # ------------------------------------------------- label-cardinality cap
    def _admit_labels_locked(self, name: str, labels: _LabelKey) -> bool:
        """Called under the lock when a series is about to be CREATED:
        unlabeled series and the drop-accounting counter itself always
        admit; labeled series admit until the per-name cap."""
        if not labels or name == _DROPPED_NAME:
            return True
        n = self._label_sets.get(name, 0)
        if n >= _LABEL_SETS_CAP:
            return False
        self._label_sets[name] = n + 1
        return True

    def _count_dropped(self, name: str) -> None:
        """Outside the lock: account + warn once per capped name."""
        # literal name (== _DROPPED_NAME): the doc-drift lint scans for it
        self.counter("obs.labels.dropped", instrument=name)
        log_once(
            f"obs.labels.capped:{name}",
            "obs registry: instrument %r exceeded the per-name label "
            "cardinality cap (%d distinct label sets); new label sets are "
            "dropped (existing series keep recording). High-cardinality "
            "dimensions (per-slice cohorts) belong in compute() results, "
            "not obs labels.",
            name,
            _LABEL_SETS_CAP,
        )

    # ------------------------------------------------------------ instruments
    def counter(self, name: str, delta: float = 1.0, **labels: Any) -> None:
        """Increment counter ``name`` (created on first use) by ``delta``."""
        key = (name, _label_key(labels))
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                if not self._admit_labels_locked(name, key[1]):
                    c = None
                else:
                    c = self._counters[key] = Counter()
            if c is not None:
                c.inc(delta)
                return
        self._count_dropped(name)

    def gauge(self, name: str, value: float, **labels: Any) -> None:
        """Set gauge ``name`` (created on first use) to ``value``."""
        key = (name, _label_key(labels))
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                if not self._admit_labels_locked(name, key[1]):
                    g = None
                else:
                    g = self._gauges[key] = Gauge()
            if g is not None:
                g.set(value)
                return
        self._count_dropped(name)

    def histo(self, name: str, value: float, **labels: Any) -> None:
        """Record ``value`` into histogram ``name`` (created on first use)."""
        key = (name, _label_key(labels))
        with self._lock:
            h = self._histos.get(key)
            if h is None:
                if not self._admit_labels_locked(name, key[1]):
                    h = None
                else:
                    h = self._histos[key] = Histogram()
            if h is not None:
                h.record(value)
                return
        self._count_dropped(name)

    def span(self, name: str, **labels: Any) -> _Span:
        """Context manager timing a host-side span.

        Spans opened while another span is active on the same thread record
        under the joined path ``"outer/inner"`` — nested attribution with no
        double counting (the outer span still includes the inner's time, as
        a profiler trace would)."""
        return _Span(self, name, _label_key(labels))

    def observe_span(self, path: str, seconds: float, **labels: Any) -> None:
        """Record an already-measured duration under span ``path`` (no
        nesting — the caller measured around something that already ran,
        e.g. a time taken with CUDA events)."""
        self._record_span(
            path,
            _label_key(labels),
            seconds,
            t0=time.perf_counter() - seconds,
        )

    # --------------------------------------------------------------- plumbing
    def _span_stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record_span(
        self,
        path: str,
        labels: _LabelKey,
        seconds: float,
        t0: Optional[float] = None,
        parent: Optional[str] = None,
    ) -> None:
        key = (path, labels)
        dropped = False
        with self._lock:
            s = self._spans.get(key)
            if s is None:
                if not self._admit_labels_locked(path, labels):
                    dropped = True
                else:
                    s = self._spans[key] = SpanStats()
            if s is not None:
                s.record(seconds)
        if dropped:
            self._count_dropped(path)
            return
        # default-registry spans mirror into the event timeline ring
        # (obs/trace.py): the sink call sits OUTSIDE the registry lock
        if _span_sink is not None and self is default_registry:
            _span_sink(
                path,
                labels,
                t0 if t0 is not None else time.perf_counter() - seconds,
                seconds,
                parent,
            )

    # ----------------------------------------------------------------- export
    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time copy as plain JSON-serialisable data:
        ``{"counters": {...}, "gauges": {...}, "histograms": {...},
        "spans": {...}}``.

        Keys are ``name`` or ``name{k=v,...}`` when labelled (the Prometheus
        spelling, so snapshot keys and exposition lines correlate 1:1).
        Span entries and histograms carry p50/p95/p99 estimated from the
        log2 buckets — latency distributions, not only min/max/sum."""
        fmt = format_key
        with self._lock:
            return {
                "counters": {
                    fmt(n, lb): c.value for (n, lb), c in self._counters.items()
                },
                "gauges": {
                    fmt(n, lb): g.value for (n, lb), g in self._gauges.items()
                },
                "histograms": {
                    fmt(n, lb): {
                        "count": h.count,
                        "sum": h.sum,
                        "p50": h.percentile(0.50),
                        "p95": h.percentile(0.95),
                        "p99": h.percentile(0.99),
                    }
                    for (n, lb), h in self._histos.items()
                },
                "spans": {
                    fmt(n, lb): {
                        "count": s.count,
                        "total_seconds": s.total_seconds,
                        "max_seconds": s.max_seconds,
                        "p50": percentile_from_buckets(
                            s.buckets, s.count, 0.50
                        ),
                        "p95": percentile_from_buckets(
                            s.buckets, s.count, 0.95
                        ),
                        "p99": percentile_from_buckets(
                            s.buckets, s.count, 0.99
                        ),
                    }
                    for (n, lb), s in self._spans.items()
                },
            }

    def _items(self) -> list:
        """``[(kind, name, labels, value), ...]`` — export helper. The list
        is MATERIALISED under the lock and returned: a generator yielding
        under the lock would hold it across the consumer's formatting work
        (stalling every instrumented thread for a whole export) and leak it
        outright if the consumer abandoned iteration. Span values are
        ``(count, total_seconds, max_seconds, buckets)``; histogram values
        ``(buckets, count, sum)`` — buckets copied as tuples so the consumer
        never aliases live mutable state."""
        with self._lock:
            return self._items_locked()

    def _items_locked(self) -> list:
        out: list = [
            ("counter", n, lb, c.value)
            for (n, lb), c in self._counters.items()
        ]
        out.extend(
            ("gauge", n, lb, g.value)
            for (n, lb), g in self._gauges.items()
        )
        out.extend(
            ("histo", n, lb, (tuple(h.buckets), h.count, h.sum))
            for (n, lb), h in self._histos.items()
        )
        out.extend(
            (
                "span",
                n,
                lb,
                (s.count, s.total_seconds, s.max_seconds, tuple(s.buckets)),
            )
            for (n, lb), s in self._spans.items()
        )
        return out

    # ---------------------------------------------------------------- deltas
    def delta_since(self, cursor: Optional[DeltaCursor]) -> tuple:
        """Diff the registry against ``cursor`` → ``(delta, new_cursor)``.

        ``delta`` is a plain JSON-serialisable dict carrying ONLY the series
        that changed since the cursor was issued — the O(changed) unit the
        obs push channel ships instead of full snapshots
        (the JAX package's ``obs/stream.py`` folds deltas back into
        snapshots):

        * ``counters`` — increments (``new - base``; > 0 by monotonicity);
        * ``gauges`` — new absolute values (a gauge is last-write-wins, a
          numeric difference would be meaningless);
        * ``histograms`` / ``spans`` — sparse per-bucket count increments
          (``[[index, +n], ...]``) plus count/sum (span: count/total/max)
          increments; bucket increments sum exactly to the count increment.

        ``cursor=None`` (or a cursor from before the last :meth:`reset` —
        detected by generation) yields a FULL diff with ``"full": True``.
        The returned cursor's ``seq`` strictly increases across calls on the
        same cursor chain, including across resets."""
        with self._lock:
            # one critical section for both: a reset() between reading the
            # items and the generation would mislabel old values as new-gen
            gen = self._generation
            items = self._items_locked()
        fresh = cursor is None or cursor.gen != gen
        base: Dict[tuple, Any] = {} if fresh else cursor.base
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        histos: Dict[str, Any] = {}
        spans: Dict[str, Any] = {}
        new_base: Dict[tuple, Any] = {}
        for kind, name, lb, value in items:
            bkey = (kind, name, lb)
            new_base[bkey] = value
            prev = base.get(bkey)
            key = format_key(name, lb)
            if kind == "counter":
                d = value - (prev or 0.0)
                if d != 0.0:
                    counters[key] = d
            elif kind == "gauge":
                if prev is None or value != prev:
                    gauges[key] = value
            elif kind == "histo":
                buckets, count, total = value
                pb, pc, ps = prev if prev is not None else ((), 0, 0.0)
                if count != pc:
                    histos[key] = {
                        "buckets": [
                            [i, c - (pb[i] if i < len(pb) else 0)]
                            for i, c in enumerate(buckets)
                            if c != (pb[i] if i < len(pb) else 0)
                        ],
                        "count": count - pc,
                        "sum": total - ps,
                    }
            else:  # span
                count, total, mx, buckets = value
                pc, pt, pm, pb = prev if prev is not None else (0, 0.0, 0.0, ())
                if count != pc:
                    spans[key] = {
                        "buckets": [
                            [i, c - (pb[i] if i < len(pb) else 0)]
                            for i, c in enumerate(buckets)
                            if c != (pb[i] if i < len(pb) else 0)
                        ],
                        "count": count - pc,
                        "total_seconds": total - pt,
                        # max is monotone within a generation: ship the new
                        # absolute max, the accumulator takes max() over it
                        "max_seconds": mx,
                    }
        seq = 1 if cursor is None else cursor.seq + 1
        delta = {
            "v": 1,
            "gen": gen,
            "seq": seq,
            "full": bool(fresh),
            "counters": counters,
            "gauges": gauges,
            "histograms": histos,
            "spans": spans,
        }
        return delta, DeltaCursor(gen, seq, new_base)

    def reset(self) -> None:
        """Drop every instrument (fresh registry semantics). Live span
        contexts on other threads finish into fresh entries. Outstanding
        :class:`DeltaCursor` holders observe the generation bump and get a
        full diff on their next :meth:`delta_since`."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histos.clear()
            self._spans.clear()
            self._label_sets.clear()
            self._generation += 1


# The process-wide default registry every library call site reports into.
default_registry = Registry()


def counter(
    name: str,
    delta: float = 1.0,
    *,
    registry: Optional[Registry] = None,
    **labels: Any,
) -> None:
    """Increment a counter on the default registry IF obs is enabled —
    the guarded spelling library call sites use."""
    if not _enabled:
        return
    (registry or default_registry).counter(name, delta, **labels)


def gauge(
    name: str,
    value: float,
    *,
    registry: Optional[Registry] = None,
    **labels: Any,
) -> None:
    """Set a gauge on the default registry IF obs is enabled."""
    if not _enabled:
        return
    (registry or default_registry).gauge(name, value, **labels)


def histo(
    name: str,
    value: float,
    *,
    registry: Optional[Registry] = None,
    **labels: Any,
) -> None:
    """Record into a histogram on the default registry IF obs is enabled."""
    if not _enabled:
        return
    (registry or default_registry).histo(name, value, **labels)


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


def span(name: str, **labels: Any):
    """Span on the default registry IF obs is enabled; a shared no-op
    context manager (no allocation) otherwise."""
    if not _enabled:
        return _NULL_SPAN
    return default_registry.span(name, **labels)


def snapshot() -> Dict[str, Any]:
    """Snapshot the default registry (works whether or not obs is enabled)."""
    return default_registry.snapshot()


def reset() -> None:
    """Reset the default registry."""
    default_registry.reset()
