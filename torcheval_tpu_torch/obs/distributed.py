"""Cross-rank obs aggregation: every rank's registry and timeline merged
into one view in ONE collective round.

JAX counterpart: ``torcheval_tpu/obs/distributed.py``, ported whole.
:func:`sync_snapshot` joins the ranks' registries in-library, over the
toolkit's gather funnel that every metric sync rides
(``metrics/toolkit.py::_allgather_stacked``), so it inherits the chaos hook,
the deadline watchdog and the degraded-local policy, and its wire cost is
observable: exactly one more ``toolkit.sync.rounds``.

Wire: each rank pickles a structured dump of its default registry
(counters, gauges, histograms and spans as ``(name, labels, value)`` items)
plus its timeline events, pads it into a fixed ``max_bytes`` uint8 buffer
behind an 8-byte length header, and one round moves every rank's buffer
(the fixed size is what makes one round enough). The buffer goes where the
group's backend reads collectives (``utils/dist.py::collective_device``):
to the card and back under NCCL, nowhere under gloo. A rank whose dump
exceeds the budget degrades in stages (events dropped first, then
everything but a stub) and flags itself ``truncated``; it never raises
alone (that would hang its peers mid-collective) and never sends more than
``max_bytes``. Both packages write and read the same buffer.

Merge semantics, per instrument:

* **counters**: summed across ranks (same ``(name, labels)`` series);
* **gauges**: each rank's value keeps its identity under an appended
  ``rank=`` label;
* **histograms**: bucket-summed (the log2 edges are the same in every
  process), percentiles re-estimated on the merged buckets;
* **spans**: counts and totals summed, max of max, buckets summed;
* **timeline events**: rank-tagged and concatenated, ordered by ``(rank,
  ts)``; per-process ``perf_counter`` clocks are not comparable, so no
  cross-rank alignment is attempted.

Failure semantics (the toolkit's): ``timeout_s`` bounds the round; on
expiry, or a transport error from a dead peer, ``on_failure="raise"``
raises the :class:`~torcheval_tpu_torch.metrics.toolkit.SyncError`, while
``"local"`` warns once, counts ``toolkit.sync.timeouts{policy=local}`` and
returns this rank's view with ``"degraded": True``.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.obs import registry as _registry
from torcheval_tpu_torch.obs import trace as _trace
from torcheval_tpu_torch.obs.registry import format_key, percentile_from_buckets
from torcheval_tpu_torch.utils import dist as _dist

_HEADER_BYTES = 8
DEFAULT_MAX_BYTES = 1 << 20  # per-rank snapshot budget; see sync_snapshot()


def _local_payload(rank: int) -> Dict[str, Any]:
    """This rank's registry + timeline as a plain picklable structure
    (items keep the registry's ``(name, labels, value)`` form so the merge
    is structural, not string-parsing)."""
    counters: List[Tuple[str, tuple, float]] = []
    gauges: List[Tuple[str, tuple, float]] = []
    histos: List[Tuple[str, tuple, Any]] = []
    spans: List[Tuple[str, tuple, Any]] = []
    for kind, name, labels, value in _registry.default_registry._items():
        if kind == "counter":
            counters.append((name, labels, value))
        elif kind == "gauge":
            gauges.append((name, labels, value))
        elif kind == "histo":
            histos.append((name, labels, value))
        else:
            spans.append((name, labels, value))
    return {
        "rank": rank,
        "counters": counters,
        "gauges": gauges,
        "histos": histos,
        "spans": spans,
        "events": _trace.events(),
        "truncated": False,
    }


def _encode(payload: Dict[str, Any], max_bytes: int) -> np.ndarray:
    """Fixed-size wire buffer: 8-byte little-endian length + pickle. Over
    budget, stage down (drop events, then everything but a stub) — NEVER
    raise one-sidedly, never exceed ``max_bytes``."""
    budget = max_bytes - _HEADER_BYTES
    stages = [
        payload,
        {**payload, "events": [], "truncated": True},
        {"rank": payload["rank"], "counters": [], "gauges": [], "histos": [],
         "spans": [], "events": [], "truncated": True},
    ]
    raw = b""
    for stage in stages:
        raw = pickle.dumps(stage)
        if len(raw) <= budget:
            break
    if len(raw) > budget:
        # even the stub does not fit (absurdly small max_bytes): send an
        # empty buffer — the peers decode it as None and drop this rank
        # from the merge, which still beats crashing mid-collective
        raw = b""
    buf = np.zeros(max_bytes, dtype=np.uint8)
    buf[:_HEADER_BYTES] = np.frombuffer(
        len(raw).to_bytes(_HEADER_BYTES, "little"), dtype=np.uint8
    )
    buf[_HEADER_BYTES : _HEADER_BYTES + len(raw)] = np.frombuffer(
        raw, dtype=np.uint8
    )
    return buf


def _decode(buf: np.ndarray) -> Optional[Dict[str, Any]]:
    try:
        n = int.from_bytes(buf[:_HEADER_BYTES].tobytes(), "little")
        if n <= 0 or n > buf.size - _HEADER_BYTES:
            return None
        return pickle.loads(buf[_HEADER_BYTES : _HEADER_BYTES + n].tobytes())
    except Exception:
        return None


def _merge(
    payloads: List[Dict[str, Any]],
    world_size: int,
    *,
    degraded: bool = False,
) -> Dict[str, Any]:
    """Fold per-rank payloads into one cluster view (see module doc for the
    per-instrument semantics)."""
    counters: Dict[Tuple[str, tuple], float] = {}
    gauges: Dict[Tuple[str, tuple], float] = {}
    histos: Dict[Tuple[str, tuple], list] = {}  # [buckets, count, sum]
    spans: Dict[Tuple[str, tuple], list] = {}  # [count, total, max, buckets]
    events: List[Dict[str, Any]] = []
    truncated_ranks: List[int] = []
    for p in payloads:
        rank = p.get("rank", 0)
        if p.get("truncated"):
            truncated_ranks.append(rank)
        for name, labels, value in p.get("counters", ()):
            key = (name, tuple(labels))
            counters[key] = counters.get(key, 0.0) + value
        for name, labels, value in p.get("gauges", ()):
            key = (name, tuple(labels) + (("rank", str(rank)),))
            gauges[key] = value
        for name, labels, value in p.get("histos", ()):
            buckets, count, total = value
            key = (name, tuple(labels))
            acc = histos.get(key)
            if acc is None:
                histos[key] = [list(buckets), count, total]
            else:
                for i, c in enumerate(buckets):
                    acc[0][i] += c
                acc[1] += count
                acc[2] += total
        for name, labels, value in p.get("spans", ()):
            count, total, mx, buckets = value
            key = (name, tuple(labels))
            acc = spans.get(key)
            if acc is None:
                spans[key] = [count, total, mx, list(buckets)]
            else:
                acc[0] += count
                acc[1] += total
                acc[2] = max(acc[2], mx)
                for i, c in enumerate(buckets):
                    acc[3][i] += c
        for e in p.get("events", ()):
            events.append({**e, "rank": rank})
    events.sort(key=lambda e: (e.get("rank", 0), e.get("ts", 0.0)))
    return {
        "world_size": world_size,
        "ranks": sorted(p.get("rank", 0) for p in payloads),
        "degraded": degraded,
        "truncated_ranks": sorted(truncated_ranks),
        "counters": {
            format_key(n, lb): v for (n, lb), v in counters.items()
        },
        "gauges": {format_key(n, lb): v for (n, lb), v in gauges.items()},
        "histograms": {
            format_key(n, lb): {
                "count": count,
                "sum": total,
                "p50": percentile_from_buckets(buckets, count, 0.50),
                "p95": percentile_from_buckets(buckets, count, 0.95),
                "p99": percentile_from_buckets(buckets, count, 0.99),
            }
            for (n, lb), (buckets, count, total) in histos.items()
        },
        "spans": {
            format_key(n, lb): {
                "count": count,
                "total_seconds": total,
                "max_seconds": mx,
                "p50": percentile_from_buckets(buckets, count, 0.50),
                "p95": percentile_from_buckets(buckets, count, 0.95),
                "p99": percentile_from_buckets(buckets, count, 0.99),
            }
            for (n, lb), (count, total, mx, buckets) in spans.items()
        },
        "events": events,
    }


def sync_snapshot(
    *,
    timeout_s: Optional[float] = None,
    on_failure: str = "raise",
    processes: Optional[Sequence[int]] = None,
    max_bytes: int = DEFAULT_MAX_BYTES,
) -> Dict[str, Any]:
    """Merge every rank's obs registry and timeline into one view over
    exactly one collective round.

    ``timeout_s`` / ``on_failure`` follow the toolkit's sync contract
    (``"local"`` degrades to this rank's view with ``"degraded": True``);
    ``processes`` restricts the exchange to a subgroup of global ranks;
    ``max_bytes`` is the per-rank wire budget and must be the same on every
    calling rank (it fixes the collective's buffer shape). At world size 1
    no collective runs; the local view is returned in the same shape.
    """
    # imported here: toolkit imports obs, and obs must import without it
    from torcheval_tpu_torch.metrics import toolkit as tk

    if max_bytes <= _HEADER_BYTES:
        raise ValueError(f"max_bytes must be > {_HEADER_BYTES}, got {max_bytes}.")
    tk._check_failure_policy(on_failure)
    tk._check_timeout_s(timeout_s)
    group = _dist.members(processes)
    world = len(group) if group is not None else _dist.world_size()
    rank = _dist.rank() if _dist.initialized() else 0
    # a sync API like the others: span and timeline event, at world size 1
    # too (the recorder shows the snapshot was taken)
    with _registry.span("obs.sync_snapshot", world=world):
        local = _local_payload(rank)
        if world == 1:
            return _merge([local], 1)
        buf = torch.from_numpy(_encode(local, max_bytes))
        try:
            with tk._sync_deadline(timeout_s):
                gathered = tk._allgather_stacked(buf, group, "obs-snapshot", "obs")
        except tk.SyncError as err:
            tk._sync_failure(err, on_failure)
            return _merge([local], 1, degraded=True)
        rows = gathered.cpu().numpy().reshape(world, max_bytes)
        payloads = [p for r in range(world) if (p := _decode(rows[r]))]
        return _merge(payloads, world)
