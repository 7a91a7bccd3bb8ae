"""Profiler annotation: attribute device and host time per metric and kernel.

JAX counterpart: ``torcheval_tpu/obs/annotate.py``. The JAX package enters
``jax.profiler.TraceAnnotation(name)`` plus ``jax.named_scope(name)`` and a
registry span. The port enters ``torch.profiler.record_function(name)`` plus
the same registry span: the profiler ties every kernel launched inside the
range to it, so device time is attributed per metric and per kernel entry,
as the named scope does on the TPU.

Both cost something per call, so they run only while obs is enabled, and
the range only while a profiler records: the disabled path of every
wrapper here is one module-global read, then the call, and it allocates
nothing.

Inside someone else's trace, host timing would time the transform once and
never again. :func:`_under_transform` is the port's probe for that:
``torch.compile`` tracing, a ``torch.func`` transform (the stacked folds
run member updates under ``vmap``), or CUDA-graph capture. There an
instrumented call takes the profiler range alone, with no span, as the JAX
package takes the named scope alone. ``metrics/deferred.py`` reads the same
probe to fold at once instead of deferring.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Sequence

import torch

from torcheval_tpu_torch.obs import registry as _registry

_is_functorch_wrapped = torch._C._functorch.is_functorch_wrapped_tensor
_record_function = torch.profiler.record_function
_profiler_enabled = torch._C._autograd._profiler_enabled


def _under_transform(args: Sequence[Any]) -> bool:
    """True while ``torch.compile`` traces, under a ``torch.func`` transform
    of one of ``args``, or while the current CUDA stream captures a graph."""
    if torch.compiler.is_compiling():
        return True
    cuda = False
    for a in args:
        if isinstance(a, torch.Tensor):
            if _is_functorch_wrapped(a):
                return True
            cuda = cuda or a.is_cuda
    return cuda and torch.cuda.is_current_stream_capturing()


def annotated_call(name: str, fn: Callable, args: tuple, kwargs: dict):
    """Run ``fn(*args, **kwargs)`` under full annotation (the enabled
    path): a registry span, and a profiler range while a profiler records
    (outside one, a range would cost a few microseconds a call for
    nothing); under a transform, the range alone."""
    transform = _under_transform(args if not kwargs else (*args, *kwargs.values()))
    if _profiler_enabled():
        with _record_function(name):
            if transform:
                return fn(*args, **kwargs)
            with _registry.default_registry.span(name):
                return fn(*args, **kwargs)
    if transform:
        return fn(*args, **kwargs)
    with _registry.default_registry.span(name):
        return fn(*args, **kwargs)


def traced(name: str) -> Callable[[Callable], Callable]:
    """Decorator: annotate a host-side entry point (method or function).
    Disabled path: one module-global read, then straight through."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _registry._enabled:
                return fn(*args, **kwargs)
            return annotated_call(name, fn, args, kwargs)

        wrapper.__obs_wrapped__ = fn
        return wrapper

    return deco


# the Metric protocol methods annotated per class
_PROTOCOL_METHODS = ("update", "compute", "merge_state")


def _protocol_wrapper(method: str, fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        if not _registry._enabled:
            return fn(self, *args, **kwargs)
        # named by the RUNTIME class: an intermediate base may define the
        # method, but the time belongs to the metric the user built
        name = f"metric.{method}/{type(self).__name__}"
        return annotated_call(name, fn, (self,) + args, kwargs)

    wrapper.__obs_wrapped__ = fn
    return wrapper


def instrument_protocol(cls) -> None:
    """Wrap the ``update`` / ``compute`` / ``merge_state`` that ``cls``
    itself defines (each definition is wrapped once, where it lives) with
    per-metric annotation named by the runtime class, e.g.
    ``metric.update/BinaryAUROC``. ``Metric.__init_subclass__`` calls it, so
    every metric, a user's subclass included, is annotated."""
    for method in _PROTOCOL_METHODS:
        fn = cls.__dict__.get(method)
        if fn is None or getattr(fn, "__obs_wrapped__", None) is not None:
            continue
        if isinstance(fn, (staticmethod, classmethod)):
            continue  # not the protocol's shape
        wrapped = _protocol_wrapper(method, fn)
        if getattr(fn, "__isabstractmethod__", False):
            wrapped.__isabstractmethod__ = True
        if wrapped.__doc__ is None:
            # inspect.getdoc inherits a docstring only for the original
            # function object: carry the protocol's doc over explicitly
            for base in cls.__mro__[1:]:
                doc = getattr(base.__dict__.get(method), "__doc__", None)
                if doc:
                    wrapped.__doc__ = doc
                    fn.__doc__ = doc
                    break
        setattr(cls, method, wrapped)
