"""Event timeline: a bounded, thread-safe ring of structured events plus
Chrome/Perfetto ``trace_event`` JSON export, the flight-recorder leg of obs.

JAX counterpart: ``torcheval_tpu/obs/trace.py``. Flat counters cannot say
*when* things happened or *how long each instance took*; the timeline
records every occurrence:

* every **span** recorded on the default registry (``registry._span_sink``
  mirrors span closes here), so checkpoint save and restore appear as
  Chrome complete events with their real start time and duration;
* explicit **instants/completes** from the hooks: ``resilience.checkpoint.*``
  (published, restored, quarantined) and ``resilience.chaos`` injections.

Cost model: every hook gates on the obs enable flag, ONE module-global
read on the disabled path, no allocation, no lock. While enabled, an
append is one lock acquisition and one ``deque.append``; the ring is
bounded (default 16384 events), so a multi-hour run records the newest
window of activity in O(capacity) memory and counts what it dropped.

Timestamps are ``time.perf_counter`` seconds relative to a module-load
epoch: monotonic and high-resolution, but NOT comparable across processes.
The Chrome-trace pid is the ``torch.distributed`` rank when a process group
is initialised, else 0.

Usage::

    obs.enable()
    ... run ...
    open("trace.json", "w").write(obs.chrome_trace())
    # chrome://tracing or https://ui.perfetto.dev loads it directly
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from torcheval_tpu_torch.obs import registry as _registry

DEFAULT_CAPACITY = 16384

_lock = threading.Lock()
_ring: deque = deque(maxlen=DEFAULT_CAPACITY)
_dropped = 0
# perf_counter epoch for this process: event ts are seconds since this
_epoch = time.perf_counter()


class Event:
    """One timeline entry: ``ts``/``dur`` are seconds relative to the module
    epoch (``dur == 0`` marks an instant), ``kind`` is the coarse category
    (span / window / jit / compile / sync / checkpoint / chaos), ``labels``
    a small str->value dict, ``tid`` the recording thread."""

    __slots__ = ("ts", "dur", "name", "kind", "labels", "tid")

    def __init__(
        self,
        ts: float,
        dur: float,
        name: str,
        kind: str,
        labels: Dict[str, Any],
        tid: int,
    ) -> None:
        self.ts = ts
        self.dur = dur
        self.name = name
        self.kind = kind
        self.labels = labels
        self.tid = tid

    def as_dict(self) -> Dict[str, Any]:
        return {
            "ts": self.ts,
            "dur": self.dur,
            "name": self.name,
            "kind": self.kind,
            "labels": dict(self.labels),
            "tid": self.tid,
        }


def _append(event: Event) -> None:
    global _dropped
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(event)


def instant(name: str, kind: str = "instant", **labels: Any) -> None:
    """Record a zero-duration event IF obs is enabled (one global read and
    nothing else on the disabled path)."""
    if not _registry._enabled:
        return
    _append(
        Event(
            time.perf_counter() - _epoch,
            0.0,
            name,
            kind,
            labels,
            threading.get_ident(),
        )
    )


def complete(
    name: str, t0: float, seconds: float, kind: str = "span", **labels: Any
) -> None:
    """Record a duration event whose start was ``t0`` (a ``perf_counter``
    reading) IF obs is enabled."""
    if not _registry._enabled:
        return
    _append(
        Event(
            t0 - _epoch,
            seconds,
            name,
            kind,
            labels,
            threading.get_ident(),
        )
    )


def _on_span(path: str, labels, t0: float, seconds: float) -> None:
    """Registry span sink: default-registry span closes become timeline
    complete events (labels arrive as the registry's sorted tuple form)."""
    _append(
        Event(
            t0 - _epoch,
            seconds,
            path,
            "span",
            dict(labels),
            threading.get_ident(),
        )
    )


# wire the sink: every span recorded on the default registry (only ever
# while obs is enabled — the disabled span() returns a no-op context)
# mirrors into this ring
_registry._span_sink = _on_span


def events() -> List[Dict[str, Any]]:
    """Snapshot of the ring, oldest first, as plain dicts."""
    with _lock:
        return [e.as_dict() for e in _ring]


def event_count() -> int:
    with _lock:
        return len(_ring)


def events_since(offset: int):
    """``(events, total)`` — events whose all-time index is ``>= offset``,
    plus the all-time count (``dropped + ring``), read under ONE lock so the
    pair is consistent. The obs stream's timeline cursor: a subscriber holds
    the last ``total`` it saw and gets only newer events on the next delta
    (events already evicted from the ring are simply gone — bounded memory
    wins over completeness, same contract as the ring itself). An ``offset``
    ahead of ``total`` (ring was :func:`clear`-ed, e.g. ``obs.reset()``)
    rewinds to the whole ring."""
    with _lock:
        total = _dropped + len(_ring)
        if offset > total:
            offset = 0
        start = max(0, offset - _dropped)
        return [e.as_dict() for e in list(_ring)[start:]], total


def dropped() -> int:
    """Events evicted since the last :func:`clear` (ring overflow)."""
    with _lock:
        return _dropped


def capacity() -> int:
    return _ring.maxlen or 0


def set_capacity(n: int) -> None:
    """Resize the ring (keeps the newest ``n`` events; a shrink counts the
    evicted events as dropped — the export's ``dropped_events`` must own up
    to every event the recorder lost)."""
    global _ring, _dropped
    if n < 1:
        raise ValueError(f"timeline capacity must be >= 1, got {n}.")
    with _lock:
        _dropped += max(0, len(_ring) - n)
        _ring = deque(_ring, maxlen=n)


def clear() -> None:
    """Drop every recorded event and the dropped-event count."""
    global _dropped
    with _lock:
        _ring.clear()
        _dropped = 0


def _process_rank() -> int:
    """Chrome-trace pid: the ``torch.distributed`` rank when a process
    group is initialised (so a multi-rank merge groups rows per rank), else
    0; never initialises a group just to export a trace."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def chrome_trace(
    extra_events: Optional[List[Dict[str, Any]]] = None,
    *,
    indent: Optional[int] = None,
) -> str:
    """The timeline as Chrome/Perfetto ``trace_event`` JSON (a string that
    ``chrome://tracing`` / ``ui.perfetto.dev`` load directly).

    Duration events export as phase ``"X"`` (ts/dur in microseconds),
    instants as phase ``"i"`` (thread scope). ``extra_events`` lets a
    cross-rank merge append rank-tagged event dicts (each may carry a
    ``"rank"`` used as the pid)."""
    pid = _process_rank()
    out = []
    merged = events()
    if extra_events:
        merged = merged + list(extra_events)
    for e in merged:
        entry: Dict[str, Any] = {
            "name": e["name"],
            "cat": e["kind"],
            "pid": e.get("rank", pid),
            "tid": e["tid"],
            "ts": round(e["ts"] * 1e6, 3),
            "args": e["labels"],
        }
        if e["dur"] > 0.0:
            entry["ph"] = "X"
            entry["dur"] = round(e["dur"] * 1e6, 3)
        else:
            entry["ph"] = "i"
            entry["s"] = "t"
        out.append(entry)
    doc = {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "producer": "torcheval_tpu_torch.obs",
            "dropped_events": dropped(),
        },
    }
    return json.dumps(doc, indent=indent, default=str)
