"""Delta-snapshot streaming: telemetry units of O(changed) size.

JAX counterpart: ``torcheval_tpu/obs/stream.py``, ported whole. A host that
streams its registry every second cannot re-serialise the full snapshot on
each tick: a busy registry holds hundreds of series of which a quiet tick
touches a handful. :meth:`Registry.delta_since` (``registry.py``) produces
the diff; this module owns everything around it:

* :func:`collect`: one *stream delta*, the registry diff plus the timeline
  events recorded since the cursor, under one opaque :class:`StreamCursor`;
* :class:`DeltaAccumulator`: the receive side, which folds deltas back into
  an absolute view whose :meth:`DeltaAccumulator.snapshot` is shaped
  exactly like ``Registry.snapshot()`` (same keys, same percentile
  estimator), so applying every delta gives the snapshot one would have
  fetched;
* :func:`delta_nbytes`: the serialised size of a delta.

Nothing here runs unless something calls it: importing this module adds no
instrumentation and no threads, and nothing to the disabled path. A
``collect`` call while obs is disabled is legal and returns an empty delta.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from torcheval_tpu_torch.obs import registry as _registry
from torcheval_tpu_torch.obs import trace as _trace
from torcheval_tpu_torch.obs.registry import (
    HISTOGRAM_BUCKETS,
    DeltaCursor,
    Registry,
    percentile_from_buckets,
)

__all__ = [
    "StreamCursor",
    "collect",
    "DeltaAccumulator",
    "delta_nbytes",
]


class StreamCursor:
    """Opaque position in the obs stream: the registry's
    :class:`~torcheval_tpu_torch.obs.registry.DeltaCursor` plus the all-time
    timeline event index. Created by :func:`collect`; never constructed or
    inspected by callers (a publisher holds one per subscription)."""

    __slots__ = ("registry_cursor", "events_seen")

    def __init__(
        self, registry_cursor: DeltaCursor, events_seen: int
    ) -> None:
        self.registry_cursor = registry_cursor
        self.events_seen = events_seen


def collect(
    cursor: Optional[StreamCursor] = None,
    *,
    registry: Optional[Registry] = None,
    include_events: bool = True,
    max_events: int = 2048,
) -> Tuple[Dict[str, Any], StreamCursor]:
    """One stream delta: ``(delta, new_cursor)``.

    ``delta`` is the registry diff (see ``Registry.delta_since``) with an
    ``"events"`` list appended — the timeline events recorded since the
    cursor, newest ``max_events`` of them (a burst of events must not turn
    one push into a megabyte; the trim is counted in ``"events_trimmed"``
    so the receiver knows the recorder saw more than it shipped)."""
    reg = registry or _registry.default_registry
    rdelta, rcursor = reg.delta_since(
        cursor.registry_cursor if cursor is not None else None
    )
    events_seen = cursor.events_seen if cursor is not None else 0
    if rdelta["full"]:
        # a generation bump (obs.reset()) cleared the timeline ring too:
        # rewind the event cursor so post-reset events aren't skipped
        # while the all-time index catches back up to the stale offset
        events_seen = 0
    if include_events:
        events, total = _trace.events_since(events_seen)
        trimmed = 0
        if len(events) > max_events:
            trimmed = len(events) - max_events
            events = events[-max_events:]
        rdelta["events"] = events
        rdelta["events_trimmed"] = trimmed
        events_seen = total
    else:
        rdelta["events"] = []
        rdelta["events_trimmed"] = 0
    return rdelta, StreamCursor(rcursor, events_seen)


def delta_nbytes(delta: Dict[str, Any]) -> int:
    """Serialised (compact JSON, UTF-8) size of a delta: the wire cost a
    push pays."""
    return len(
        json.dumps(delta, separators=(",", ":"), default=str).encode()
    )


def _dense(sparse) -> List[int]:
    out = [0] * HISTOGRAM_BUCKETS
    for i, c in sparse:
        out[i] = c
    return out


class DeltaAccumulator:
    """Folds a sequence of deltas back into an absolute registry view.

    The receive side of a push channel, one per subscribed host.
    :meth:`apply` is associative with the registry's diff
    — applying every delta since a cursor reproduces, exactly, the snapshot
    the registry would have served at the last delta's instant (bucket
    counts included, which is why histogram deltas are shipped per-bucket
    and sum-exact). A delta marked ``"full"`` (first push, or the host
    reset its registry) replaces the accumulated state instead of adding to
    it. Not thread-safe: callers serialise."""

    def __init__(self) -> None:
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        # key -> [buckets(list), count, sum]
        self._histos: Dict[str, list] = {}
        # key -> [buckets(list), count, total_seconds, max_seconds]
        self._spans: Dict[str, list] = {}
        self.events: List[Dict[str, Any]] = []
        self.events_trimmed = 0
        self.applied = 0
        self.last_seq: Optional[int] = None

    def apply(self, delta: Dict[str, Any]) -> None:
        if delta.get("full"):
            self._counters.clear()
            self._gauges.clear()
            self._histos.clear()
            self._spans.clear()
        for k, d in delta.get("counters", {}).items():
            self._counters[k] = self._counters.get(k, 0.0) + d
        for k, v in delta.get("gauges", {}).items():
            self._gauges[k] = v
        for k, d in delta.get("histograms", {}).items():
            h = self._histos.get(k)
            if h is None:
                h = self._histos[k] = [[0] * HISTOGRAM_BUCKETS, 0, 0.0]
            for i, c in d["buckets"]:
                h[0][i] += c
            h[1] += d["count"]
            h[2] += d["sum"]
        for k, d in delta.get("spans", {}).items():
            s = self._spans.get(k)
            if s is None:
                s = self._spans[k] = [[0] * HISTOGRAM_BUCKETS, 0, 0.0, 0.0]
            for i, c in d["buckets"]:
                s[0][i] += c
            s[1] += d["count"]
            s[2] += d["total_seconds"]
            s[3] = max(s[3], d["max_seconds"])
        self.events.extend(delta.get("events", ()))
        self.events_trimmed += delta.get("events_trimmed", 0)
        self.applied += 1
        self.last_seq = delta.get("seq", self.last_seq)

    def snapshot(self) -> Dict[str, Any]:
        """The accumulated state in ``Registry.snapshot()`` shape (same
        percentile estimator over the same reconstructed buckets)."""
        return {
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "histograms": {
                k: {
                    "count": h[1],
                    "sum": h[2],
                    "p50": percentile_from_buckets(h[0], h[1], 0.50),
                    "p95": percentile_from_buckets(h[0], h[1], 0.95),
                    "p99": percentile_from_buckets(h[0], h[1], 0.99),
                }
                for k, h in self._histos.items()
            },
            "spans": {
                k: {
                    "count": s[1],
                    "total_seconds": s[2],
                    "max_seconds": s[3],
                    "p50": percentile_from_buckets(s[0], s[1], 0.50),
                    "p95": percentile_from_buckets(s[0], s[1], 0.95),
                    "p99": percentile_from_buckets(s[0], s[1], 0.99),
                }
                for k, s in self._spans.items()
            },
        }
