"""Per-entry device cost gauges: what one launch of a hand kernel moves.

JAX counterpart: ``torcheval_tpu/obs/cost.py``, which reads XLA's
``cost_analysis()`` and ``memory_analysis()`` off every compiled program.
PyTorch has no such analysis, so each of the four hand-kernel wrappers
(``ops/hist.py``, ``ops/stream_compact.py``, ``ops/topk.py``,
``ops/scatter.py``) states its own byte model, the one ``PERF.md``'s bounds
use: each input read once, each output written once. The gauges keep the
JAX names:

* ``obs.cost.flops{entry=}``: the float adds the contract performs (0 for
  the integer histogram, the compaction and the top-k's comparisons);
* ``obs.cost.bytes_accessed{entry=}``: the model's bytes, the roofline
  numerator;
* ``obs.cost.hbm_bytes{entry=}``: the bytes of one launch's argument,
  output and scratch tensors.

``obs.cost.captures{entry=}`` counts the attributions and
``obs.cost.capture_errors{entry=}`` the models that raised (a model must
never break a launch). The recompile watchdog (``obs/recompile.py``) calls
:func:`capture` on the first sight of each signature of an entry that has a
model, while obs is enabled; gauges are last-write-wins per entry, as in
the JAX package. The gauges are counts, not times: no CUDA event is
recorded here.

The library-op entries (the curve kernels, the confusion counts, the
folds) get no cost gauges: their JAX gauges come from XLA programs the port
does not have.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Tuple

from torcheval_tpu_torch.obs import registry as _registry

# a cost model: (args, kwargs, output) -> (flops, bytes_accessed, hbm_bytes)
CostModel = Callable[[tuple, Dict[str, Any], Any], Tuple[float, float, float]]


def nbytes(*tensors) -> int:
    """Total bytes of ``tensors`` (``None`` entries skipped)."""
    return sum(int(t.numel()) * t.element_size() for t in tensors if t is not None)


def capture(entry: str, model: CostModel, args: tuple, kwargs: Dict[str, Any], out: Any) -> None:
    """Publish ``model``'s cost of the call ``entry(*args, **kwargs) ->
    out`` as the entry's gauges."""
    if not _registry._enabled:
        return
    reg = _registry.default_registry
    t0 = time.perf_counter()
    try:
        flops, bytes_accessed, hbm = model(args, kwargs, out)
        reg.gauge("obs.cost.flops", float(flops), entry=entry)
        reg.gauge("obs.cost.bytes_accessed", float(bytes_accessed), entry=entry)
        reg.gauge("obs.cost.hbm_bytes", float(hbm), entry=entry)
        reg.counter("obs.cost.captures", entry=entry)
    except Exception:
        reg.counter("obs.cost.capture_errors", entry=entry)
    finally:
        reg.observe_span("obs.cost.capture", time.perf_counter() - t0, entry=entry)
