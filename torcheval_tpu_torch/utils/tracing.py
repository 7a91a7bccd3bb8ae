"""Value checks that never make the caller wait for the device.

JAX counterpart: ``torcheval_tpu/utils/tracing.py``. A warning on a
degenerate value (a class with no label, a throughput with no update)
needs the value on the host, and reading a CUDA tensor there waits for
every kernel queued before it. :func:`async_value_warn` moves that wait to
a daemon thread: the warning fires a moment later, and the caller's stream
of kernel launches runs on. :func:`host_resident` says whether reading a
value costs no device wait, so eager input checks read only such values.

PyTorch has no tracers, so the JAX module's ``is_concrete`` has no
counterpart here: every tensor holds its values. A check made under a
``torch.func`` transform or while a CUDA graph is captured is skipped, as
the JAX package skips one inside a trace.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from torcheval_tpu_torch.obs.annotate import _under_transform

_logger = logging.getLogger(__name__)

_is_functorch_wrapped = torch._C._functorch.is_functorch_wrapped_tensor


def host_resident(x: Any) -> bool:
    """True when reading ``x``'s values costs no device wait: a CPU tensor,
    a numpy array (anything with ``__array__``) or a Python number. False
    for a CUDA tensor, and for a Python list, as in the JAX package."""
    if isinstance(x, torch.Tensor):
        return x.device.type == "cpu" and not _is_functorch_wrapped(x)
    return isinstance(x, (bool, int, float)) or hasattr(x, "__array__")


_threads: List[threading.Thread] = []
_threads_lock = threading.Lock()


def join_pending(timeout: Optional[float] = None) -> bool:
    """Wait for every check :func:`async_value_warn` started (a test's
    deterministic wait before it reads the log). True when none is left
    running."""
    with _threads_lock:
        pending = list(_threads)
    for t in pending:
        t.join(timeout)
    with _threads_lock:
        _threads[:] = [t for t in _threads if t.is_alive()]
        return not _threads


def async_value_warn(check: Callable[..., None], *values: Any) -> Optional[threading.Thread]:
    """Run ``check(*host_values)``, which may log a warning, on a daemon
    thread, with each tensor of ``values`` read back as a numpy array (other
    values as numpy arrays). Returns the thread, or None when the
    check is skipped (under a transform or a graph capture).

    A CUDA tensor's copy into a pinned host buffer is enqueued here, on the
    current stream of the tensor's device, and a CUDA event is recorded
    after it there: the copy runs before any later kernel can reuse the
    tensor's memory (the caching allocator orders reuse on that stream),
    and the thread waits on those events alone. The caller never blocks."""
    if _under_transform(values):
        return None
    staged, events = [], []
    for v in values:
        if isinstance(v, torch.Tensor) and v.is_cuda:
            with torch.cuda.device(v.device):
                host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host.copy_(v.detach(), non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            staged.append(host)
            events.append(event)
        elif isinstance(v, torch.Tensor):
            staged.append(v.detach().clone())
        else:
            staged.append(v)

    def _worker() -> None:
        try:
            for event in events:
                event.synchronize()
            check(*(s.numpy() if isinstance(s, torch.Tensor) else np.asarray(s) for s in staged))
        except Exception:  # a failing check must never reach the caller
            _logger.debug("async value-warning check failed", exc_info=True)

    t = threading.Thread(target=_worker, name="async-value-warn", daemon=True)
    with _threads_lock:
        _threads[:] = [p for p in _threads if p.is_alive()]
        _threads.append(t)
    t.start()
    return t
