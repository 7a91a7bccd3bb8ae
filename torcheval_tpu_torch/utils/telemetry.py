"""Once-per-key API-usage telemetry.

JAX counterpart: ``torcheval_tpu/utils/telemetry.py``, ported whole. The
reference torcheval logs every metric construction through
``torch._C._log_api_usage_once(f"torcheval.metrics.{cls}")``, so fleet
owners can count which metrics are used. This module is the same hook on
``logging``: one DEBUG record per unique key per process on the
``torcheval_tpu_torch.api_usage`` logger, plus a registration point for a
custom sink (a production telemetry client, say).

:func:`log_once` opens the once-per-key machinery to the library's own
warnings that must not repeat in a hot loop: the recompile watchdog's storm
warning, the degraded-sync warning, the registry's label-cap warning and the
approximate-mode notices. ``obs.reset()`` re-arms every key.

The hot-path cost is a set lookup: no handler work unless a sink or a
DEBUG-level handler is attached, and never more than once per key.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional, Set

_logger = logging.getLogger("torcheval_tpu_torch.api_usage")

_seen: Set[str] = set()
_seen_lock = threading.Lock()
_sink: Optional[Callable[[str], None]] = None


def set_api_usage_sink(sink: Optional[Callable[[str], None]]) -> None:
    """Install a callable invoked once per unique API-usage key (or ``None``
    to remove it), as ``torch._C._log_api_usage_once`` feeds a
    deployment's usage counters."""
    global _sink
    _sink = sink


def _first_time(key: str) -> bool:
    """True exactly once per unique key per process (thread-safe)."""
    if key in _seen:  # the common already-seen case takes no lock
        return False
    with _seen_lock:
        if key in _seen:
            return False
        _seen.add(key)
    return True


def log_api_usage_once(key: str) -> None:
    """Record one use of ``key`` (``"torcheval_tpu_torch.metrics.BinaryAUROC"``);
    later calls with the same key do nothing."""
    if not _first_time(key):
        return
    _logger.debug("API usage: %s", key)
    if _sink is not None:
        try:
            _sink(key)
        except Exception:  # a broken sink must never break a metric's construction
            _logger.exception("api-usage sink failed for key %r", key)


def log_once(key: str, message: str, *args, level: int = logging.WARNING) -> None:
    """Emit ``message % args`` through the telemetry logger once per unique
    ``key``."""
    if not _first_time(key):
        return
    _logger.log(level, message, *args)


def reset_once_keys(prefix: str = "") -> None:
    """Forget the recorded keys that start with ``prefix`` (every key when
    empty), so a fresh run's warnings fire again."""
    with _seen_lock:
        if not prefix:
            _seen.clear()
        else:
            for k in [k for k in _seen if k.startswith(prefix)]:
                _seen.discard(k)
