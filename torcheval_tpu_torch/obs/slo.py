"""SLO objectives and burn alarms over the registry's rolling histograms.

JAX counterpart: ``torcheval_tpu/obs/slo.py``, ported whole. An operator
declares latency objectives against instruments that already exist::

    slo = obs.Slo(
        "submit_p99",
        instrument="serve.submit.latency",
        threshold_s=0.250,
        window_s=60.0,
        budget=0.01,          # <=1% of observations may exceed threshold
    )
    obs.register_slo(slo)
    obs.on_alarm(lambda payload: page_someone(payload))

Evaluation (:func:`evaluate_slos`, called explicitly or on a publisher's
tick) windows the *cumulative* log2 histograms by sampling: each
evaluation remembers ``(t, buckets, count)`` per series and diffs the
current sample against the newest sample older than ``window_s`` — the
bucket difference is exactly the observations recorded inside the window
(the same sum-exact bucket algebra the delta stream uses). From the
windowed buckets:

* ``bad`` = observations in buckets whose upper edge exceeds
  ``threshold_s`` (bucketed, so the effective threshold rounds DOWN to the
  containing bucket's lower edge — conservative: never under-counts);
* ``burn_rate`` = ``(bad / total) / budget`` — 1.0 means the error budget
  is being consumed exactly at the sustainable rate; recorded as
  ``slo.burn_rate{objective=}`` (max across the instrument's label sets);
* a series whose burn rate reaches 1.0 **breaches**: counted once per
  transition into ``slo.breach{objective=,tenant=}`` (tenant label only
  when the series carries one — the label-cardinality cap applies as
  usual) and fired once per transition through the alarm hooks. Breaches
  are edge-triggered: a stuck-bad series alarms once, not once per
  evaluation, and re-arms only after the window slides clean.

The alarm-hook registry (:func:`on_alarm` / :func:`remove_alarm`) is
thread-safe and generic: any subsystem may :func:`fire_alarm` a payload
(``{"kind": "slo.breach", ...}`` here). A raising callback is logged and
dropped, never allowed to take down the thread that evaluated the
objective.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from torcheval_tpu_torch.obs import registry as _registry
from torcheval_tpu_torch.obs.registry import Registry, bucket_upper_edge
from torcheval_tpu_torch.utils.telemetry import log_once

__all__ = [
    "Slo",
    "register_slo",
    "unregister_slo",
    "registered_slos",
    "evaluate_slos",
    "on_alarm",
    "remove_alarm",
    "fire_alarm",
]


# ------------------------------------------------------------- alarm hooks
_alarm_lock = threading.Lock()
_alarm_cbs: List[Callable[[Dict[str, Any]], None]] = []


def on_alarm(cb: Callable[[Dict[str, Any]], None]) -> None:
    """Register ``cb(payload: dict)`` to run on every alarm (SLO breaches
    today; any subsystem may :func:`fire_alarm`). Idempotent per callback."""
    with _alarm_lock:
        if cb not in _alarm_cbs:
            _alarm_cbs.append(cb)


def remove_alarm(cb: Callable[[Dict[str, Any]], None]) -> None:
    """Unregister a callback (no-op if absent)."""
    with _alarm_lock:
        try:
            _alarm_cbs.remove(cb)
        except ValueError:
            pass


def fire_alarm(payload: Dict[str, Any]) -> None:
    """Invoke every registered alarm hook with ``payload``. Callbacks run
    on the CALLER's thread (for SLOs: the evaluating thread — keep them
    cheap); one raising callback is logged and skipped, the rest still
    fire."""
    with _alarm_lock:
        cbs = list(_alarm_cbs)
    for cb in cbs:
        try:
            cb(payload)
        except Exception:
            log_once(
                f"obs.alarm.cb_error:{cb!r}",
                "obs alarm callback %r raised; alarm dropped for this "
                "callback (others still fire).",
                cb,
            )


class Slo:
    """One service-level objective over a histogram/span instrument.

    ``objective`` names the SLO (label value on its instruments);
    ``instrument`` is the registry histogram (or span path) it watches;
    observations above ``threshold_s`` inside the trailing ``window_s``
    consume the error ``budget`` (fraction, e.g. ``0.01`` = 1%).
    ``min_count`` suppresses evaluation until the window holds that many
    observations (default 1 — a single terrible request CAN breach, which
    is what a p99-style objective with a tiny budget means)."""

    def __init__(
        self,
        objective: str,
        *,
        instrument: str,
        threshold_s: float,
        window_s: float = 60.0,
        budget: float = 0.01,
        min_count: int = 1,
    ) -> None:
        if threshold_s <= 0.0:
            raise ValueError(
                f"threshold_s must be > 0, got {threshold_s!r}."
            )
        if window_s <= 0.0:
            raise ValueError(f"window_s must be > 0, got {window_s!r}.")
        if not 0.0 < budget <= 1.0:
            raise ValueError(
                f"budget must be in (0, 1], got {budget!r}."
            )
        self.objective = objective
        self.instrument = instrument
        self.threshold_s = float(threshold_s)
        self.window_s = float(window_s)
        self.budget = float(budget)
        self.min_count = int(min_count)
        # per-series sample history: label-key -> deque[(t, buckets, count)]
        self._samples: Dict[tuple, deque] = {}
        self._breached: Dict[tuple, bool] = {}
        self._lock = threading.Lock()

    # threshold -> first bucket index counted as "bad" (upper edge beyond
    # the threshold: conservative, the containing bucket counts entirely)
    def _first_bad_bucket(self) -> int:
        for i in range(_registry.HISTOGRAM_BUCKETS):
            if bucket_upper_edge(i) > self.threshold_s:
                return i
        return _registry.HISTOGRAM_BUCKETS - 1

    def evaluate(
        self,
        *,
        registry: Optional[Registry] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Evaluate every label set of ``instrument`` against the window.

        Returns ``{"objective":, "burn_rate": max-across-series,
        "breaches": [series-key, ...] (new transitions this call),
        "series": {key: {"burn_rate":, "bad":, "total":, "breached":}}}``,
        records ``slo.burn_rate`` / ``slo.breach`` into the registry, and
        fires the alarm hooks once per new breach."""
        reg = registry or _registry.default_registry
        t = time.monotonic() if now is None else now
        first_bad = self._first_bad_bucket()
        series: Dict[str, Dict[str, Any]] = {}
        new_breaches: List[str] = []
        max_burn = 0.0
        with self._lock:
            seen = set()
            for kind, name, lb, value in reg._items():
                if name != self.instrument:
                    continue
                if kind == "histo":
                    buckets, count = value[0], value[1]
                elif kind == "span":
                    count, buckets = value[0], value[3]
                else:
                    continue
                seen.add(lb)
                dq = self._samples.get(lb)
                if dq is None:
                    dq = self._samples[lb] = deque()
                dq.append((t, buckets, count))
                # baseline: the newest sample at or beyond the window edge
                while len(dq) >= 2 and dq[1][0] <= t - self.window_s:
                    dq.popleft()
                if dq[0][0] <= t - self.window_s:
                    base_b, base_c = dq[0][1], dq[0][2]
                else:
                    base_b, base_c = (), 0  # series younger than window
                total = count - base_c
                bad = sum(
                    buckets[i] - (base_b[i] if i < len(base_b) else 0)
                    for i in range(first_bad, len(buckets))
                )
                burn = 0.0
                if total >= self.min_count and total > 0:
                    burn = (bad / total) / self.budget
                max_burn = max(max_burn, burn)
                was = self._breached.get(lb, False)
                breached = burn >= 1.0
                self._breached[lb] = breached
                key = _registry.format_key(name, lb)
                series[key] = {
                    "burn_rate": burn,
                    "bad": bad,
                    "total": total,
                    "breached": breached,
                }
                if breached and not was:
                    new_breaches.append(key)
                    labels = {"objective": self.objective}
                    tenant = dict(lb).get("tenant")
                    if tenant is not None:
                        labels["tenant"] = tenant
                    reg.counter("slo.breach", **labels)
            # forget series the registry dropped (reset): re-arm them
            for lb in list(self._samples):
                if lb not in seen:
                    del self._samples[lb]
                    self._breached.pop(lb, None)
        reg.gauge("slo.burn_rate", max_burn, objective=self.objective)
        result = {
            "objective": self.objective,
            "burn_rate": max_burn,
            "breaches": new_breaches,
            "series": series,
        }
        for key in new_breaches:
            fire_alarm(
                {
                    "kind": "slo.breach",
                    "objective": self.objective,
                    "series": key,
                    "instrument": self.instrument,
                    "threshold_s": self.threshold_s,
                    "window_s": self.window_s,
                    "budget": self.budget,
                    "burn_rate": series[key]["burn_rate"],
                    "ts": time.time(),
                }
            )
        return result


# --------------------------------------------------------- module registry
_slo_lock = threading.Lock()
_slos: List[Slo] = []


def register_slo(slo: Slo) -> Slo:
    """Add ``slo`` to the process-wide set :func:`evaluate_slos` walks
    (a publisher may evaluate them every tick). Returns it."""
    with _slo_lock:
        if slo not in _slos:
            _slos.append(slo)
    return slo


def unregister_slo(slo: Slo) -> None:
    with _slo_lock:
        try:
            _slos.remove(slo)
        except ValueError:
            pass


def registered_slos() -> List[Slo]:
    with _slo_lock:
        return list(_slos)


def evaluate_slos(
    *, registry: Optional[Registry] = None, now: Optional[float] = None
) -> List[Dict[str, Any]]:
    """Evaluate every registered SLO; returns their result dicts. Safe to
    call with none registered (returns ``[]`` without touching the
    registry) — the publisher tick's steady-state cost."""
    out = []
    for slo in registered_slos():
        out.append(slo.evaluate(registry=registry, now=now))
    return out


def _reset_for_tests() -> None:
    """Drop registered SLOs and alarm hooks (test isolation)."""
    with _slo_lock:
        _slos.clear()
    with _alarm_lock:
        _alarm_cbs.clear()
