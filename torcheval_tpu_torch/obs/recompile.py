"""Recompile watchdog: per-entry signature counts and retrace-storm warnings.

JAX counterpart: ``torcheval_tpu/obs/recompile.py`` (``watched_jit``). The
contract is the JAX one. A call's signature has two halves: the **static
key** (the pytree structure of the arguments plus every non-tensor leaf,
an object compared by identity standing by its type; distinct statics are
distinct programs) and the **dynamic signature**
(``(shape, dtype)`` per tensor leaf; Python scalars are static, since torch
has no weak types). A **storm** is :func:`retrace_threshold` distinct
dynamic signatures under one static key of one :func:`watched` wrapper: a
drifting argument (an unpadded last batch, a varying scalar) that would
recompile a jitted program on every few calls. The watchdog warns once per
entry through ``utils/telemetry.py::log_once``, naming the latest
signature.

While obs is enabled, each wrapper records:

* ``recompile.traces{entry=}`` and a ``watched_jit.trace`` instant on the
  first sight of a signature (the JAX package records them per XLA trace);
* ``jit.calls{entry=}`` on every call. The four hand-kernel wrappers
  count it themselves, where they launch (:func:`count_launch`), so that a
  kernel's launches are its ``jit.calls``: a CPU tensor runs the plain
  version, which is not a launch;
* a profiler range and a registry span named ``jit/<entry>`` around the
  call (``obs/annotate.py``);
* a ``jit.compile/<entry>`` span on a call that built the kernel library
  (``_build.py``'s ``nvcc`` run);
* the entry's cost gauges (``obs/cost.py``) on the first sight of a
  signature, for a wrapper given a cost model, and, on every launch of a
  hand kernel, its byte model's bytes into ``obs.cost.launch_bytes{entry=}``
  (:func:`count_launch`).

**Difference from the JAX package.** JAX's bookkeeping is free: it runs
only on a jit cache miss, inside the traced function. Eager PyTorch has no
cache miss to hook, so spotting a new signature costs a tree flatten, a
tuple build and a dict lookup on every call. The port's watchdog therefore
runs only while obs is enabled, and its disabled path is one global read.
The port has no jit either, so the first sight of a signature is not a
compile; only a kernel build is.
"""

from __future__ import annotations

import functools
import threading
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from torcheval_tpu_torch import _build
from torcheval_tpu_torch.obs import cost as _cost
from torcheval_tpu_torch.obs import registry as _registry
from torcheval_tpu_torch.obs import trace as _trace
from torcheval_tpu_torch.obs.annotate import annotated_call
from torcheval_tpu_torch.utils.telemetry import log_once, reset_once_keys

_WARN_KEY_PREFIX = "torcheval_tpu_torch.obs.recompile/"

_lock = threading.Lock()
# entry name -> {full signature -> first sightings}
_traces: Dict[str, Dict[Any, int]] = {}
# every live wrapper's static-key -> {dynamic signatures} store, held
# weakly so that reset() clears them while a dropped wrapper's store stays
# collectable
_group_stores: "weakref.WeakSet" = weakref.WeakSet()
_threshold = 8


class _GroupStore(dict):
    """A wrapper's static-key -> {dynamic signatures} store: a dict subclass
    only so that :data:`_group_stores` can hold it weakly, with identity
    hashing so that two empty stores stay distinct members."""

    __hash__ = object.__hash__

    def __eq__(self, other):
        return self is other

    def __ne__(self, other):
        return self is not other


def retrace_threshold() -> int:
    """Distinct dynamic signatures per static key before the watchdog warns
    (default 8: a steady eval loop sees 1-3)."""
    return _threshold


def set_retrace_threshold(n: int) -> None:
    if n < 2:
        raise ValueError(f"retrace threshold must be >= 2, got {n}.")
    global _threshold
    _threshold = n


_FLAT = (int, float, bool, str, type(None))


def split_signature(args: tuple, kwargs: dict) -> Tuple[Any, Any]:
    """``(static_key, dynamic_sig)`` of a call (module doc). A call of
    tensors and Python scalars alone, by position (the common call), needs
    no tree flatten: its static key is the positions' kinds and scalars."""
    if not kwargs and all(type(a) in _FLAT or isinstance(a, torch.Tensor) for a in args):
        static_flat = tuple(None if isinstance(a, torch.Tensor) else (a,) for a in args)
        dynamic_flat = tuple(
            (tuple(a.shape), str(a.dtype)) for a in args if isinstance(a, torch.Tensor)
        )
        return ("flat", static_flat), dynamic_flat
    leaves, spec = pytree.tree_flatten((args, kwargs))
    dynamic = []
    static = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            dynamic.append((tuple(leaf.shape), str(leaf.dtype)))
        elif type(leaf).__hash__ in (None, object.__hash__):
            # an object compared by identity (a metric, a process group) or
            # not at all stands by its type: its program is its class's, and
            # the bookkeeping must not keep it alive
            static.append(type(leaf).__qualname__)
        else:
            static.append(leaf)
    return (str(spec), tuple(static)), tuple(dynamic)


def _first_sight(
    name: str, args: tuple, kwargs: dict, groups: Dict[Any, set], signature: Callable = split_signature
) -> bool:
    """Record the call's signature for ``name``; True when this wrapper had
    not seen it (the port's counterpart of a JAX trace)."""
    static_key, dynamic = signature(args, kwargs)
    with _lock:
        seen = groups.setdefault(static_key, set())
        if dynamic in seen:
            return False
        seen.add(dynamic)
        distinct = len(seen)
        per_entry = _traces.setdefault(name, {})
        full = (static_key, dynamic)
        per_entry[full] = per_entry.get(full, 0) + 1
        total = sum(per_entry.values())
    _registry.counter("recompile.traces", entry=name)
    _trace.instant("watched_jit.trace", kind="jit", entry=name)
    if distinct >= _threshold:
        log_once(
            _WARN_KEY_PREFIX + name,
            "Retrace storm on entry point %r: %d signatures seen, %d distinct "
            "dynamic signatures for one static configuration (threshold %d). A "
            "drifting shape or dtype argument would recompile this entry per "
            "call under a jit: pad batches to a fixed shape or hoist the varying "
            "argument. Most recent signature: %r",
            name,
            total,
            distinct,
            _threshold,
            (static_key, dynamic),
        )
    return True


def trace_counts() -> Dict[str, Dict[str, int]]:
    """``{entry: {"traces": first sightings, "distinct_signatures": n}}``,
    the watchdog's bookkeeping (filled while obs is enabled)."""
    with _lock:
        return {
            name: {"traces": sum(d.values()), "distinct_signatures": len(d)}
            for name, d in _traces.items()
        }


def reset() -> None:
    """Clear the bookkeeping, every wrapper's signature store included, and
    re-arm the once-per-entry storm warnings."""
    with _lock:
        _traces.clear()
        for groups in list(_group_stores):
            groups.clear()
    reset_once_keys(_WARN_KEY_PREFIX)


def count_launch(
    entry: str,
    model: Optional[_cost.CostModel] = None,
    args: tuple = (),
    out: Any = None,
) -> None:
    """A hand kernel's launch while obs is enabled: one
    ``jit.calls{entry=}``, and ``model``'s bytes of the launch
    ``entry(*args) -> out`` into ``obs.cost.launch_bytes{entry=}``. The
    kernel wrappers call it where they launch, and nowhere else."""
    if _registry._enabled:
        _registry.default_registry.counter("jit.calls", entry=entry)
        if model is not None:
            _cost.count_bytes(entry, model, args, out)


def watched(
    fun: Optional[Callable] = None,
    *,
    name: Optional[str] = None,
    cost: Optional[_cost.CostModel] = None,
    counts_launches: bool = False,
    signature: Callable[[tuple, dict], Tuple[Any, Any]] = split_signature,
) -> Callable:
    """Wrap a library entry point with the watchdog (module doc): the port's
    ``watched_jit``. ``cost`` is the entry's byte model (``obs/cost.py``);
    ``counts_launches`` says that the wrapped function counts its own
    ``jit.calls`` where it launches a kernel; ``signature`` computes a
    call's ``(static_key, dynamic_sig)`` where a tree flatten of every
    argument would cost more than the call (a window of many batches).
    Usable as ``@watched`` or ``@watched(name=...)``. Disabled path: one
    module-global read."""
    if fun is None:
        return lambda f: watched(
            f, name=name, cost=cost, counts_launches=counts_launches, signature=signature
        )
    label = name or getattr(fun, "__qualname__", None) or repr(fun)
    groups: Dict[Any, set] = _GroupStore()
    with _lock:
        _group_stores.add(groups)

    @functools.wraps(fun)
    def call(*args, **kwargs):
        if not _registry._enabled:
            return fun(*args, **kwargs)
        reg = _registry.default_registry
        if not counts_launches:
            reg.counter("jit.calls", entry=label)
        first = _first_sight(label, args, kwargs, groups, signature)
        building = not _build.loaded()
        t0 = time.perf_counter()
        out = annotated_call(f"jit/{label}", fun, args, kwargs)
        if building and _build.loaded() and _build.build_report()[0] is not None:
            # this call built the kernels: the port's compile
            reg.observe_span(f"jit.compile/{label}", time.perf_counter() - t0)
        if first and cost is not None:
            _cost.capture(label, cost, args, kwargs, out)
        return out

    call.__obs_entry__ = label
    call.__wrapped__ = fun
    return call
