"""The ``Metric`` base class.

JAX counterpart: ``torcheval_tpu/metrics/metric.py``. The protocol is the
same: concrete metrics register state with :meth:`Metric._add_state` and
implement ``update``, ``compute`` and ``merge_state``; the base class gives
``reset``, ``state_dict``/``load_state_dict(strict)``, ``to()``, deepcopy and
pickling. State is ``torch.Tensor``s on the metric's device, which is
``cuda:0`` unless the caller passes another (``device="cpu"`` runs on the
CPU). With no GPU, the default raises.

Metrics with a pure fold defer it (``metrics/deferred.py``): ``update``
appends the batch, and :meth:`Metric._fold_now` folds the pending batches.
Every read of the logical state calls it first: ``state_dict``,
``load_state_dict`` (so a partial load keeps the pending contribution of the
states it does not name), ``to`` and ``_prepare_for_merge_state`` (every
sync); the mixin adds pickling and deepcopy.

Every subclass's ``update``/``compute``/``merge_state`` is annotated for the
profiler and the obs registry under the runtime class's name
(``metric.update/BinaryAUROC``, ``obs/annotate.py``), and the first
construction of each class is logged once
(``torcheval_tpu_torch.metrics.<class>``, ``utils/telemetry.py``), as in the
JAX package. Both cost one global read or one set lookup while obs is off.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections import defaultdict, deque
from typing import Any, Dict, Generic, Iterable, Optional, TypeVar

import torch

from torcheval_tpu_torch.metrics.state import (
    Reduction,
    TState,
    check_state_type,
    copy_state,
    put_state,
)
from torcheval_tpu_torch.obs.annotate import instrument_protocol
from torcheval_tpu_torch.utils.convert import as_tensor
from torcheval_tpu_torch.utils.devices import DeviceLike, canonical_device
from torcheval_tpu_torch.utils.telemetry import log_api_usage_once


def _zero_scalar() -> torch.Tensor:
    """Module-level default factory, so defaultdict state stays picklable."""
    return torch.zeros(())


TComputeReturn = TypeVar("TComputeReturn")
TSelf = TypeVar("TSelf", bound="Metric")


class Metric(Generic[TComputeReturn], ABC):
    """Abstract streaming metric. ``compute()`` must be idempotent and must
    not mutate state."""

    def __init_subclass__(cls, **kwargs: Any) -> None:
        # per-class span names: "metric.update/BinaryAUROC"
        super().__init_subclass__(**kwargs)
        instrument_protocol(cls)

    def __init__(self, *, device: DeviceLike = None) -> None:
        log_api_usage_once(f"torcheval_tpu_torch.metrics.{type(self).__name__}")
        self._device = canonical_device(device)
        self._state_name_to_default: Dict[str, TState] = {}
        self._state_name_to_reduction: Dict[str, Reduction] = {}

    # ------------------------------------------------------------------ state
    def _add_state(
        self, name: str, default: TState, *, reduction: Optional[Reduction] = None
    ) -> None:
        """Register a state variable and its cross-replica reduction.

        ``default`` may be a tensor (or anything ``torch.as_tensor`` takes),
        a list, a dict, or a deque of tensors. Without ``reduction``,
        lists and deques are CAT and everything else SUM."""
        if not isinstance(default, (list, dict, deque, torch.Tensor)):
            default = torch.as_tensor(default)
        check_state_type(name, default)
        if reduction is None:
            reduction = Reduction.CAT if isinstance(default, (list, deque)) else Reduction.SUM
        self._state_name_to_default[name] = copy_state(default)
        self._state_name_to_reduction[name] = reduction
        setattr(self, name, put_state(copy_state(default), self._device))

    @property
    def state_names(self) -> tuple:
        return tuple(self._state_name_to_default)

    def _states(self) -> Dict[str, TState]:
        return {n: getattr(self, n) for n in self._state_name_to_default}

    def _set_states(self, values: Dict[str, TState]) -> None:
        for name, value in values.items():
            setattr(self, name, value)

    def _input(self, x) -> torch.Tensor:
        """An update argument (tensor, numpy or Python) as a tensor on this
        metric's device; a tensor already there is used as it is."""
        return as_tensor(x, self._device)

    # --------------------------------------------------------------- protocol
    @abstractmethod
    def update(self: TSelf, *args: Any, **kwargs: Any) -> TSelf:
        """Fold a batch into the metric state."""

    @abstractmethod
    def compute(self) -> TComputeReturn:
        """The result from the current state; idempotent."""

    @abstractmethod
    def merge_state(self: TSelf, metrics: Iterable[TSelf]) -> TSelf:
        """Merge other replicas' state into self (the others unchanged)."""

    def _prepare_for_merge_state(self) -> None:
        """Pre-sync compaction hook (e.g. concatenate a sample cache so a
        collective moves one buffer)."""
        self._fold_now()

    def _fold_now(self) -> None:
        """Fold any deferred work into the logical state. A no-op here;
        :class:`~torcheval_tpu_torch.metrics.deferred.DeferredFoldMixin`
        overrides it."""

    # ------------------------------------------------------------- life cycle
    def reset(self: TSelf) -> TSelf:
        """Reset every state variable to its registered default."""
        for name, default in self._state_name_to_default.items():
            value = put_state(copy_state(default), self._device)
            if isinstance(default, dict) and not isinstance(value, defaultdict):
                # plain-dict defaults gain missing-key-is-zero semantics
                d = defaultdict(_zero_scalar)
                d.update(value)
                value = d
            setattr(self, name, value)
        return self

    def state_dict(self) -> Dict[str, TState]:
        """A copy of the state as a plain dict (tensors cloned, so later
        in-place updates do not reach the snapshot)."""
        self._fold_now()
        out: Dict[str, TState] = {}
        for name in self._state_name_to_default:
            value = getattr(self, name)
            check_state_type(name, value)
            out[name] = copy_state(value)
        return out

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True) -> None:
        """Install ``state_dict`` (copied, placed on this metric's device).
        Pending work is folded into the current state first, so a partial
        load keeps it in the states it does not overwrite."""
        self._fold_now()
        state_dict = dict(state_dict)
        names = set(self._state_name_to_default)
        for name in names:
            if name in state_dict:
                value = state_dict[name]
                check_state_type(name, value)
                setattr(self, name, put_state(copy_state(value), self._device))
        if strict:
            unexpected = set(state_dict) - names
            missing = names - set(state_dict)
            if missing or unexpected:
                raise RuntimeError(
                    f"Error(s) in loading state_dict for {type(self).__name__}. "
                    f"Encountered missing keys: {missing} and unexpected keys: "
                    f"{unexpected}."
                )

    def to(self: TSelf, device: DeviceLike, *args: Any, **kwargs: Any) -> TSelf:
        """Move all state to ``device``."""
        self._fold_now()
        self._device = canonical_device(device)
        for name in self._state_name_to_default:
            setattr(self, name, put_state(getattr(self, name), self._device))
        return self

    @property
    def device(self) -> torch.device:
        return self._device

    def __repr__(self) -> str:
        return f"{type(self).__name__}(device={self._device})"
