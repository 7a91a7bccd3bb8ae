"""``torcheval_tpu_torch.obs``: the port's host-side flight recorder.

JAX counterpart: ``torcheval_tpu/obs/``, of which two modules are ported:

* the **registry** (``registry.py``): thread-safe process-wide counters,
  gauges, log2-bucket histograms and nested span timers, with the JAX
  package's names, label keys, bucket edges and ``snapshot()`` layout;
* the **event timeline** (``trace.py``): a bounded ring of structured
  events fed by every default-registry span and by the checkpoint and
  chaos hooks, exported as Chrome/Perfetto ``trace_event`` JSON.

Not yet ported: ``annotate``, ``cost``, ``distributed`` (the cross-rank
``sync_snapshot``), ``export`` (Prometheus text and ``to_json``),
``httpd``, ``recompile``, ``slo``, ``stream`` and ``utils/telemetry.py``.
The port's other layers count with plain function attributes
(``toolkit._allgather_stacked.rounds``, each kernel wrapper's
``.launches``); the resilience layer (``resilience/``) reports here.

Usage::

    from torcheval_tpu_torch import obs
    obs.enable()
    ... save / restore checkpoints ...
    obs.snapshot()["spans"]["resilience.checkpoint.save"]
    open("trace.json", "w").write(obs.chrome_trace())
"""

from torcheval_tpu_torch.obs import registry as _registry_mod
from torcheval_tpu_torch.obs import trace as _trace_mod
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
from torcheval_tpu_torch.obs.trace import chrome_trace
from torcheval_tpu_torch.obs.trace import events as timeline_events
from torcheval_tpu_torch.obs.trace import set_capacity as set_timeline_capacity


def reset() -> None:
    """One reset across the ported obs: every registry instrument, the
    event timeline ring and the once-per-name label-cap warnings."""
    default_registry.reset()
    _trace_mod.clear()
    _registry_mod.reset_warnings()


__all__ = [
    "Histogram",
    "Registry",
    "chrome_trace",
    "counter",
    "default_registry",
    "disable",
    "enable",
    "enabled",
    "gauge",
    "histo",
    "reset",
    "set_label_cardinality_cap",
    "set_timeline_capacity",
    "snapshot",
    "span",
    "timeline_events",
]
