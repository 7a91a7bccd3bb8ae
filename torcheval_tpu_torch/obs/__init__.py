"""``torcheval_tpu_torch.obs``: the port's flight recorder.

JAX counterpart: ``torcheval_tpu/obs/``, ported whole; ``watched`` stands
where the JAX package's ``watched_jit`` stands (``recompile.py``: PyTorch
has no jit, so the watchdog wraps eager entry points). The legs:

* **Registry** (``registry.py``): thread-safe process-wide counters,
  gauges, log2-bucket histograms (p50/p95/p99 in ``snapshot()``) and nested
  span timers, with the JAX package's names, label keys and bucket edges
  (``inventory.py`` lists every name the port records). It is the port's
  one counting mechanism: a kernel's launches are its
  ``jit.calls{entry=}``, a sync's rounds ``toolkit.sync.rounds``, a
  window's cadence ``deferred.*``. Exported as JSON and Prometheus text
  (``export.py``).
* **Event timeline** (``trace.py``): a bounded ring of structured events fed
  by every registry span and by hooks at each dispatch site (window
  open/append/valve/close, window-step dispatch, folds, watchdog first
  sights and cache hits, sync rounds, checkpoints, chaos injections), as
  Chrome/Perfetto ``trace_event`` JSON (``chrome_trace()``).
* **Profiler annotation** (``annotate.py``): every metric's ``update`` /
  ``compute`` / ``merge_state`` (``metric.update/BinaryAUROC``), the
  collection's, the evaluator's, the toolkit's entry points and every
  watched entry (``jit/<entry>``) run inside a
  ``torch.profiler.record_function`` range and a registry span, so device
  time is attributed per metric and per kernel.
* **Recompile watchdog and cost gauges** (``recompile.py``, ``cost.py``):
  per-entry signature counts with a storm warning, and the hand kernels'
  byte models as ``obs.cost.*{entry=}`` gauges.
* **Cross-rank aggregation** (``distributed.py``): :func:`sync_snapshot`
  merges every rank's registry and timeline in one collective round.
* **Streaming, objectives and scraping** (``stream.py``, ``slo.py``,
  ``httpd.py``): delta snapshots, SLO burn-rate alarms, and ``GET
  /metrics`` / ``GET /health`` on a stdlib thread.

Everything records only while :func:`enable` is on; the disabled path of
every call site is one module-global read.

Usage::

    from torcheval_tpu_torch import obs
    obs.enable()
    ... run the eval loop ...
    obs.snapshot()["counters"]["jit.calls{entry=hist}"]   # histogram launches
    print(obs.prometheus_text())
    open("trace.json", "w").write(obs.chrome_trace())
    obs.sync_snapshot(timeout_s=30, on_failure="local")   # every rank's view
"""

from torcheval_tpu_torch.obs import recompile as _recompile_mod
from torcheval_tpu_torch.obs import trace as _trace_mod
from torcheval_tpu_torch.obs.distributed import sync_snapshot
from torcheval_tpu_torch.obs.export import prometheus_text, to_json
from torcheval_tpu_torch.obs.httpd import MetricsServer
from torcheval_tpu_torch.obs.recompile import (
    retrace_threshold,
    set_retrace_threshold,
    trace_counts,
    watched,
)
from torcheval_tpu_torch.obs.registry import (
    Histogram,
    Registry,
    counter,
    default_registry,
    disable,
    enable,
    enabled,
    gauge,
    histo,
    set_label_cardinality_cap,
    snapshot,
    span,
)
from torcheval_tpu_torch.obs.slo import (
    Slo,
    evaluate_slos,
    fire_alarm,
    on_alarm,
    register_slo,
    remove_alarm,
    unregister_slo,
)
from torcheval_tpu_torch.obs.stream import DeltaAccumulator, StreamCursor
from torcheval_tpu_torch.obs.stream import collect as collect_delta
from torcheval_tpu_torch.obs.trace import chrome_trace
from torcheval_tpu_torch.obs.trace import events as timeline_events
from torcheval_tpu_torch.obs.trace import set_capacity as set_timeline_capacity
from torcheval_tpu_torch.utils.telemetry import reset_once_keys as _reset_once_keys


def reset() -> None:
    """One reset across the subsystem: every registry instrument (cost
    gauges included), the timeline ring, the recompile watchdog's
    bookkeeping, and every ``log_once`` key (storm, degraded-sync and
    label-cap warnings fire again; API-usage keys log again)."""
    default_registry.reset()
    _trace_mod.clear()
    _recompile_mod.reset()
    _reset_once_keys()


__all__ = [
    "DeltaAccumulator",
    "Histogram",
    "MetricsServer",
    "Registry",
    "Slo",
    "StreamCursor",
    "chrome_trace",
    "collect_delta",
    "counter",
    "default_registry",
    "disable",
    "enable",
    "enabled",
    "evaluate_slos",
    "fire_alarm",
    "gauge",
    "histo",
    "on_alarm",
    "prometheus_text",
    "register_slo",
    "remove_alarm",
    "reset",
    "retrace_threshold",
    "set_label_cardinality_cap",
    "set_retrace_threshold",
    "set_timeline_capacity",
    "snapshot",
    "span",
    "sync_snapshot",
    "timeline_events",
    "to_json",
    "trace_counts",
    "unregister_slo",
    "watched",
]
