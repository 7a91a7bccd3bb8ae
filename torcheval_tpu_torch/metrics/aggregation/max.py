"""Max metric.

JAX counterpart: ``torcheval_tpu/metrics/aggregation/max.py``. The running
maximum is not additive, so the fold threads state through
``torch.maximum`` (``_fold_reduce``) instead of an add.

The JAX state starts as ``jnp.asarray(-jnp.inf)``, a weakly typed float, so
the first batch's floating type wins: bfloat16 or float16 input keeps its
type. Here the default is a float32 tensor, and the state is marked weak
until a batch, a merge or a load reaches it; a weak state takes the
floating type of what it meets (:class:`_ExtremumMetric`).
"""

from __future__ import annotations

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction
from torcheval_tpu_torch.utils.devices import DeviceLike


def _max_deferred_fold(input):
    return {"max": torch.max(input)}


def _max_deferred_compute(max):  # noqa: A002 - the state's name
    return max


def _weak_combine(op, cur, cur_weak: bool, new, new_weak: bool) -> torch.Tensor:
    """``op(cur, new)`` where a weakly typed side takes the other side's
    floating type, as JAX promotes a weak float against a typed array."""
    if cur_weak and not new_weak and new.is_floating_point():
        cur = cur.to(new.dtype)
    elif new_weak and not cur_weak and cur.is_floating_point():
        new = new.to(cur.dtype)
    return op(cur, new)


class _ExtremumMetric(DeferredFoldMixin, Metric[torch.Tensor]):
    """Shared body of :class:`Max` and :class:`Min`: one scalar state named
    ``_state_name`` with the identity ``_identity``, combined by
    ``_fold_reduce``."""

    _fold_per_chunk = True
    _state_name = ""
    _identity = 0.0

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        red = Reduction.MAX if self._fold_reduce is torch.maximum else Reduction.MIN
        self._add_state(self._state_name, torch.tensor(self._identity), reduction=red)
        self._init_deferred()
        self._weak = True

    def update(self, input):
        self._defer(self._input(input))
        return self

    def _apply_deltas(self, deltas) -> None:
        name = self._state_name
        value = _weak_combine(
            type(self)._fold_reduce, getattr(self, name), self._weak, deltas[name], False
        )
        setattr(self, name, value)
        self._weak = False

    def compute(self) -> torch.Tensor:
        return self._deferred_compute()

    def merge_state(self, metrics: Iterable["_ExtremumMetric"]):
        metrics = self._fold_for_merge(metrics)
        name = self._state_name
        for metric in metrics:
            value = _weak_combine(
                type(self)._fold_reduce,
                getattr(self, name),
                self._weak,
                getattr(metric, name).to(self._device),
                metric._weak,
            )
            setattr(self, name, value)
            self._weak = self._weak and metric._weak
        return self

    def reset(self):
        super().reset()
        self._weak = True
        return self

    def load_state_dict(self, state_dict, strict: bool = True) -> None:
        super().load_state_dict(state_dict, strict)
        if self._state_name in state_dict:
            self._weak = False


class Max(_ExtremumMetric):
    """Streaming maximum over all seen elements (-inf before any update,
    float32 or the first batch's floating type; NaN propagates)."""

    _fold_fn = staticmethod(_max_deferred_fold)
    _fold_reduce = staticmethod(torch.maximum)
    _compute_fn = staticmethod(_max_deferred_compute)
    _state_name = "max"
    _identity = float("-inf")
