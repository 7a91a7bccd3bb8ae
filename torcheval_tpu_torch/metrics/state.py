"""Metric state containers and cross-replica reduction declarations.

JAX counterpart: ``torcheval_tpu/metrics/state.py``. Every state variable
declares its :class:`Reduction` when it is registered, so a sync layer can
merge it with a typed collective instead of pickling the metric.

State container types:

* ``torch.Tensor``: counters, on the metric's device;
* ``list[torch.Tensor]``: append-only sample caches (AUROC/AUPRC), concatenated
  on axis 0 when merged;
* ``dict[Any, torch.Tensor]``: keyed accumulators;
* ``deque[torch.Tensor]``: bounded windows.
"""

from __future__ import annotations

import enum
from collections import defaultdict, deque
from typing import Any, Deque, Dict, List, Union

import torch

TState = Union[
    torch.Tensor, List[torch.Tensor], Dict[Any, torch.Tensor], Deque[torch.Tensor]
]


class Reduction(enum.Enum):
    """How a state variable combines across metric replicas and ranks."""

    SUM = "sum"  # elementwise add
    MAX = "max"  # elementwise max
    MIN = "min"  # elementwise min
    CAT = "cat"  # concatenate along axis 0
    NONE = "none"  # identical on all ranks
    WINDOW = "window"  # bounded deque of same-shape rows, extended in rank order
    CUSTOM = "custom"  # only mergeable through the metric's merge_state()


def check_state_type(name: str, value: Any) -> None:
    """Validate a state value against the TState union."""
    if isinstance(value, torch.Tensor):
        return
    if isinstance(value, (list, deque)):
        for v in value:
            if not isinstance(v, torch.Tensor):
                raise TypeError(
                    f"Element of state {name!r} must be a tensor, got {type(v)!r}."
                )
        return
    if isinstance(value, dict):
        for k, v in value.items():
            if not isinstance(v, torch.Tensor):
                raise TypeError(
                    f"Value of state {name!r}[{k!r}] must be a tensor, got {type(v)!r}."
                )
        return
    raise TypeError(
        f"State {name!r} must be a tensor, or a list, dict or deque of tensors, "
        f"got {type(value)!r}."
    )


def put_state(value: TState, device: torch.device) -> TState:
    """Place a state value (any container type) on ``device``. Tensors
    already there are not copied."""
    if isinstance(value, (list, deque)):
        moved = [v.to(device) for v in value]
        if isinstance(value, deque):
            return deque(moved, maxlen=value.maxlen)
        return moved
    if isinstance(value, dict):
        out = {k: v.to(device) for k, v in value.items()}
        if isinstance(value, defaultdict) and value.default_factory is not None:
            d = defaultdict(value.default_factory)
            d.update(out)
            return d
        return out
    return value.to(device)


def zeros_state(shape=(), dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A zeros tensor for a state default: a CPU template that
    :func:`put_state` places on the metric's device."""
    shape = tuple(shape) if hasattr(shape, "__len__") else (shape,)
    return torch.zeros(shape, dtype=dtype)


def copy_state(value: TState) -> TState:
    """Deep copy of a state value: fresh tensors, copied containers."""
    if isinstance(value, list):
        return [v.clone() for v in value]
    if isinstance(value, deque):
        return deque((v.clone() for v in value), maxlen=value.maxlen)
    if isinstance(value, defaultdict):
        d = defaultdict(value.default_factory)
        d.update({k: v.clone() for k, v in value.items()})
        return d
    if isinstance(value, dict):
        return {k: v.clone() for k, v in value.items()}
    return value.clone()
