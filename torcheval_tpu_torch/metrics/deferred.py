"""The fold contract of array-state metrics.

JAX counterpart: ``torcheval_tpu/metrics/deferred.py`` (the
``DeferredFoldMixin`` contract: ``_fold_fn``, ``_fold_reduce``,
``_compute_fn`` and their statics, ``_apply_deltas`` and
``_deferred_compute``). A metric declares its per-batch math as a
module-level pure function, and its terminal compute as another, so that a
wrapper such as the sliced collection (``metrics/sliced.py``) can run the
same math per sample (``torch.func.vmap``) and per slice.

The JAX package defers the folds: ``update()`` appends the batch, and one
program folds the pending batches at read time or on a memory budget.
PyTorch runs eagerly, so here :meth:`DeferredFoldMixin._defer` folds at
once: it validates the batch with ``_update_check``, runs ``_fold_fn`` on it
and merges the deltas into the state with ``_fold_reduce``. The pending
windows, the byte and chunk valve, group folds and donation are not ported.

Contract for subclasses::

    def _my_fold(input, target, threshold):   # module level, pure
        return {"num_tp": ..., "num_fp": ...}  # batch -> {state: delta}

    def _my_compute(num_tp, num_fp, threshold):  # states in registration order
        return ...

    class MyMetric(DeferredFoldMixin, Metric[torch.Tensor]):
        _fold_fn = staticmethod(_my_fold)
        _compute_fn = staticmethod(_my_compute)

        def __init__(self, ..., device=None):
            super().__init__(device=device)
            self._add_state(...)
            self._fold_params = (threshold,)
            self._compute_params = (threshold,)

        def _update_check(self, input, target): ...   # shapes and types only

        def update(self, input, target):
            self._defer(self._input(input), self._input(target))
            return self

        def compute(self):
            return self._deferred_compute()
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch


class DeferredFoldMixin:
    """Mixin for array-state metrics whose update is a pure fold.

    Class attributes:

    * ``_fold_fn(*update_args, *_fold_params) -> {state: delta}``;
    * ``_fold_reduce``: ``None`` adds deltas into state; a combine such as
      ``torch.maximum`` threads extrema states instead;
    * ``_fold_vmap``: False when the fold cannot run under
      ``torch.func.vmap`` (a kernel with no batching rule), which keeps the
      metric out of the sliced collection;
    * ``_compute_fn(*states_in_registration_order, *_compute_params)``: the
      pure terminal compute, or ``None`` when compute has host-side
      behaviour;
    * ``_update_check(*update_args)``: the shape and type validation, or
      ``None``.
    """

    _fold_fn: Optional[Any] = None
    _fold_reduce: Optional[Any] = None
    _fold_vmap: bool = True
    _compute_fn: Optional[Any] = None
    _fold_params: Tuple[Any, ...] = ()
    _compute_params: Tuple[Any, ...] = ()
    _update_check: Optional[Any] = None

    def _defer(self, *args: torch.Tensor) -> None:
        """Validate one batch and fold it into the state at once."""
        check = self._update_check
        if check is not None:
            check(*args)
        self._apply_deltas(type(self)._fold_fn(*args, *self._fold_params))

    def _apply_deltas(self, deltas: Dict[str, torch.Tensor]) -> None:
        """Merge per-batch deltas into the state, out of place (a scalar
        state may widen to the delta's shape or type, as in the JAX
        package: an unweighted int32 count becomes float32 under a weighted
        update)."""
        red = type(self)._fold_reduce
        for name, delta in deltas.items():
            cur = getattr(self, name)
            setattr(self, name, cur + delta if red is None else red(cur, delta))

    def _on_window_result(self, result):
        """Host-side post-processing of a ``_compute_fn`` result (the JAX
        package applies it to the result of its in-program compute).
        Default: identity."""
        return result

    def _deferred_compute(self):
        """``compute()`` body: the pure ``_compute_fn`` on the states."""
        result = type(self)._compute_fn(
            *(getattr(self, n) for n in self._state_name_to_default),
            *self._compute_params,
        )
        return self._on_window_result(result)
