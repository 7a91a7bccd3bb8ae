"""``MetricCollection``: several metrics driven by the same update arguments.

JAX counterpart: ``torcheval_tpu/metrics/collection.py``. Each batch is
placed on the metrics' device once, and then:

* the **deferring members** (``metrics/deferred.py``: accuracy, F1, the
  aggregations, MSE, the retrieval metrics) share one
  :class:`~torcheval_tpu_torch.metrics.deferred.EvalWindow`. ``update()``
  appends the placed batch to it once for the whole collection. The first
  batch of each signature runs through the members' own ``update`` (their
  validation), after which same-signature batches take the append-only fast
  path. The window closes as one ``window_step`` (every member's fold and, at
  ``compute()``, every member's terminal compute) on the byte and chunk
  valve, at ``compute()``, at ``state_dicts()`` and at any read of a
  member's state;
* the **eager members** (the compacting ``BinaryAUROC`` and the other
  sample-cache metrics) update per batch, as before.

Batches whose window chunk would differ from the update arguments (keyword
arguments, Python scalars) run through the members' own ``update`` and
their pending lists, which fold together in one group fold.

A window owns its batches when the collection placed each one itself (from
numpy, or a CPU tensor copied to the card); only then may it release them
before the fold math runs. ``update_placed`` (batches placed by an ingest
pipeline) is not ported.

``update`` and ``compute`` are annotated for the profiler and the obs
registry (``collection.update``, ``collection.compute``); the valve lands a
``deferred.window.valve`` instant on the timeline while obs is enabled.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Union

import numpy as np
import torch

from torcheval_tpu_torch.metrics.deferred import EvalWindow, _versions
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.obs import registry as _obs
from torcheval_tpu_torch.obs import trace as _obs_trace
from torcheval_tpu_torch.obs.annotate import _under_transform, traced

_PACKAGE = "torcheval_tpu_torch."


def _placeable(x: Any) -> bool:
    """Tensors and arrays are placed once for the whole collection; Python
    scalars and other objects go to the members as they are."""
    return isinstance(x, (torch.Tensor, np.ndarray))


def _is_own(method: Any) -> bool:
    return getattr(method, "__module__", "").startswith(_PACKAGE)


class MetricCollection:
    """Drive several metrics with identical ``update(*args, **kwargs)``.

    Example::

        col = MetricCollection({
            "acc": MulticlassAccuracy(num_classes=1000),          # window
            "f1": MulticlassF1Score(num_classes=1000, average="macro"),
            "auroc": BinaryAUROC(),                                # eager
        })
        for scores, labels in loader:
            col.update(scores, labels)
        results = col.compute()      # {"acc": ..., "f1": ..., "auroc": ...}

    A single metric (not a dict) makes ``compute()`` return its result
    alone. Build separate collections for metrics fed from different
    tensors. Do not rewrite a tensor passed to ``update()`` in place before
    the window folds it: the fold raises (``metrics/deferred.py``).
    """

    def __init__(self, metrics: Union[Metric, Dict[str, Metric]]) -> None:
        self._single = isinstance(metrics, Metric)
        self.metrics: Dict[str, Metric] = (
            {"metric": metrics} if self._single else dict(metrics)
        )
        if not self.metrics:
            raise ValueError("MetricCollection needs at least one metric.")
        self._deferred = {
            n: m for n, m in self.metrics.items() if getattr(m, "_defers", False)
        }
        self._open_window()
        # place each batch once, on the first member's device
        self._place = next(iter(self.metrics.values()))._input
        self._deferred_updates = tuple(m.update for m in self._deferred.values())
        self._eager_updates = tuple(
            m.update for n, m in self.metrics.items() if n not in self._deferred
        )
        self._defer_probe = next(iter(self._deferred.values())) if self._deferred else None
        # an eager member may keep the placed tensors (a sample cache), so a
        # collection with one never owns its window's batches
        self._chunks_ownable = not self._eager_updates
        # the fast path appends without calling member update(): only safe
        # when every deferring member runs the package's own update, whose
        # whole effect per batch is the append
        self._window_armable = all(_is_own(type(m).update) for m in self._deferred.values())
        # the window close runs _compute_fn in place of compute(): a member
        # whose compute() is overridden elsewhere computes itself
        self._window_compute_keys = tuple(
            n for n, m in self._deferred.items() if _is_own(type(m).compute)
        )

    def _open_window(self) -> None:
        """The window the deferring members share, and each member's place
        in it."""
        self._window = EvalWindow(self._deferred, owner=self) if self._deferred else None
        for m in self._deferred.values():
            m._defer_managed = True
            # a list: a metric in several collections belongs to each window,
            # and a read of its state drains them all
            windows = getattr(m, "_defer_windows", None)
            if windows is None:
                windows = m._defer_windows = []
            windows.append(self._window)

    def __getstate__(self) -> Dict[str, Any]:
        # pickling folds the window's batches and carries no window (it
        # holds weak references): the unpickled collection opens its own
        if self._window is not None:
            self._window.close()
        state = dict(self.__dict__)
        state["_window"] = None
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._open_window()

    def __deepcopy__(self, memo: Dict[int, Any]) -> "MetricCollection":
        # a copy is every attribute copied, as without the pickling hooks
        new = object.__new__(type(self))
        memo[id(self)] = new
        new.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return new

    @traced("collection.update")
    def update(self, *args: Any, **kwargs: Any) -> "MetricCollection":
        return self._update_impl(args, kwargs)

    def _update_impl(self, args: tuple, kwargs: Dict[str, Any]) -> "MetricCollection":
        place = self._place
        window = self._window
        owned = self._chunks_ownable
        direct = bool(args) and not kwargs
        placed = []
        for a in args:
            if _placeable(a):
                p = place(a)
                if p is a:
                    owned = False  # the caller's own tensor
                placed.append(p)
            else:
                placed.append(a)
                direct = False  # Python scalars: the member updates convert
        args = tuple(placed)
        if kwargs:
            kwargs = {k: place(v) if _placeable(v) else v for k, v in kwargs.items()}
        for member_update in self._eager_updates:
            member_update(*args, **kwargs)
        if window is None:
            return self
        if direct and self._window_armable and not _under_transform(args):
            sig = window.sig
            match = sig is not None and len(sig) == len(args)
            if match:
                for a, sd in zip(args, sig):
                    if type(a) is not torch.Tensor or a.shape != sd[0] or a.dtype != sd[1]:
                        match = False
                        break
            if match:
                # a validated signature: append once for the whole collection
                window.append(args, _versions(args), window.sig_nbytes, owned)
            else:
                self._ingest_new_signature(args, tuple((a.shape, a.dtype) for a in args), owned)
        else:
            self._ingest_slow(args, kwargs)
        self._window_budget_check()
        return self

    def _ingest_new_signature(self, args: tuple, sig: tuple, owned: bool) -> None:
        """The first batch of a signature: run the members' own updates
        (their validation and their chunks); if every member appended
        exactly the update arguments, move that chunk into the window and
        arm the fast path for the signature."""
        window = self._window
        if window.chunks:
            head = window.chunks[0]
            if len(head) != len(args) or any(
                h.ndim != a.ndim or h.dtype != a.dtype or h.shape[1:] != a.shape[1:]
                for h, a in zip(head, args)
            ):
                # one fold never mixes signatures: close the window first
                window.close()
        members = self._deferred.values()
        depths = [len(m._pending) for m in members]
        for member_update in self._deferred_updates:
            member_update(*args)
        for m, depth in zip(members, depths):
            p = m._pending
            if (
                len(p) != depth + 1
                or len(p[-1]) != len(args)
                or any(x is not y for x, y in zip(p[-1], args))
            ):
                window.sig = None  # keep routing through the member updates
                return
        nbytes = sum(int(a.nbytes) for a in args)
        versions = next(iter(members))._pending_versions[-1]
        for m in members:
            m._pending.pop()
            m._pending_versions.pop()
            m._pending_bytes = max(m._pending_bytes - nbytes, 0)
        window.append(args, versions, nbytes, owned)
        window.sig = sig
        window.sig_nbytes = nbytes

    def _ingest_slow(self, args: tuple, kwargs: Dict[str, Any]) -> None:
        """Keyword and scalar batches: the members' own updates and pending
        lists, which group-fold at the next read."""
        for member_update in self._deferred_updates:
            member_update(*args, **kwargs)

    def _window_budget_check(self) -> None:
        # the window's batches and the probe member's stray pending ones
        # count against one budget, read from the member so that a budget
        # set on it holds
        probe = self._defer_probe
        window = self._window
        if (
            window.nbytes + probe._pending_bytes >= probe._DEFER_BUDGET_BYTES
            or len(window.chunks) + len(probe._pending) >= probe._DEFER_MAX_CHUNKS
        ):
            if _obs._enabled:
                # the valve firing explains every fold before a compute()
                _obs_trace.instant(
                    "deferred.window.valve",
                    kind="window",
                    chunks=len(window.chunks),
                    bytes=window.nbytes,
                )
            window.close()

    @traced("collection.compute")
    def compute(self) -> Any:
        out: Dict[str, Any] = {}
        if self._window is not None:
            results = self._window.close(compute_keys=self._window_compute_keys)
            for n, result in results.items():
                out[n] = self.metrics[n]._on_window_result(result)
        ordered = {n: out[n] if n in out else m.compute() for n, m in self.metrics.items()}
        return ordered["metric"] if self._single else ordered

    def reset(self) -> "MetricCollection":
        if self._window is not None:
            # the whole window is discarded before the members reset, so no
            # member folds batches that are thrown away
            self._window.clear()
        for m in self.metrics.values():
            m.reset()
        return self

    def state_dicts(self) -> Dict[str, Dict[str, Any]]:
        if self._window is not None:
            self._window.close()
        return {n: m.state_dict() for n, m in self.metrics.items()}

    def load_state_dicts(
        self, state_dicts: Dict[str, Dict[str, Any]], strict: bool = True
    ) -> "MetricCollection":
        """Install per-member state dicts (the inverse of
        :meth:`state_dicts`). ``strict`` requires the member names to match
        exactly and is passed on to each member's ``load_state_dict``, which
        folds the pending batches into the old state first, so a restore
        mid-window is exact."""
        if strict:
            unexpected = set(state_dicts) - set(self.metrics)
            missing = set(self.metrics) - set(state_dicts)
            if missing or unexpected:
                raise RuntimeError(
                    "Error(s) in loading state_dicts for MetricCollection. "
                    f"Encountered missing metric keys: {missing} and "
                    f"unexpected metric keys: {unexpected}."
                )
        for name, sd in state_dicts.items():
            if name in self.metrics:
                self.metrics[name].load_state_dict(sd, strict)
        return self

    def __getitem__(self, name: str) -> Metric:
        return self.metrics[name]

    def __repr__(self) -> str:
        kinds = ", ".join(f"{n}{'*' if n in self._deferred else ''}" for n in self.metrics)
        return f"{type(self).__name__}({kinds})  (* = deferred)"
