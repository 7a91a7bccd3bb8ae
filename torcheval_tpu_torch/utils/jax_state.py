"""Carrying metric state between the JAX package and this port.

JAX counterpart: none; this is the bridge between ``torcheval_tpu`` metrics
and their twins here. Both packages' ``state_dict()`` hold the same names,
shapes and dtypes, so a stream can start in one package and finish in the
other. The JAX side's ``state_dict()`` turned into numpy
(``{name: np.asarray(v)}``, lists element by element) loads here through
:func:`load_jax_state_dict`; :func:`numpy_state_dict` gives this side's
state in the numpy form the JAX side's ``load_state_dict`` takes.
:func:`load_jax_state_dicts` and :func:`numpy_state_dicts` do the same for a
``MetricCollection`` and a ``SlicedMetricCollection``: a sliced member's
state carries its id table in the ``slice_ids_hi``/``slice_ids_lo`` and
``slice_count`` lanes, and loading it rebuilds the table and adopts the
capacity on either side. The ``approx=`` sketch states
(``sketch_tp``/``sketch_fp``/``sketch_nan_dropped``, ``sketch_counts``,
``Quantile``'s ``bucket_counts``/``nan_dropped``, and the staged rows in the
raw caches) and a sliced sketch member's per-cohort histograms carry the
same way: loading recounts the staged rows, so the fold cadence continues
where the other package left it. None of these functions imports JAX.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Union

import numpy as np
import torch

from torcheval_tpu_torch.metrics.collection import MetricCollection
from torcheval_tpu_torch.metrics.metric import Metric

NumpyState = Dict[str, Union[np.ndarray, List[np.ndarray]]]


def _to_tensor(v: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(v))


def _converted(state: NumpyState) -> Dict[str, Any]:
    converted: Dict[str, Any] = {}
    for name, value in state.items():
        if isinstance(value, (list, tuple, deque)):
            converted[name] = [_to_tensor(v) for v in value]
        elif isinstance(value, dict):
            converted[name] = {k: _to_tensor(v) for k, v in value.items()}
        else:
            converted[name] = _to_tensor(value)
    return converted


def load_jax_state_dict(metric: Metric, state: NumpyState, strict: bool = True) -> None:
    """Install a JAX metric's state (as numpy arrays, or lists of them) into
    ``metric``, its twin in this package, on ``metric``'s device."""
    metric.load_state_dict(_converted(state), strict=strict)


def load_jax_state_dicts(
    collection: MetricCollection, states: Dict[str, NumpyState], strict: bool = True
) -> None:
    """Install a JAX collection's ``state_dicts()`` (as numpy) into its twin
    here, member by member."""
    collection.load_state_dicts(
        {name: _converted(state) for name, state in states.items()}, strict=strict
    )


def _numpy(state: Dict[str, Any]) -> NumpyState:
    out: Dict[str, Any] = {}
    for name, value in state.items():
        if isinstance(value, (list, deque)):
            out[name] = [v.cpu().numpy() for v in value]
        elif isinstance(value, dict):
            out[name] = {k: v.cpu().numpy() for k, v in value.items()}
        else:
            out[name] = value.cpu().numpy()
    return out


def numpy_state_dict(metric: Metric) -> NumpyState:
    """``metric.state_dict()`` as numpy arrays (lists stay lists), the form
    a JAX metric's ``load_state_dict`` takes."""
    return _numpy(metric.state_dict())


def numpy_state_dicts(collection: MetricCollection) -> Dict[str, NumpyState]:
    """``collection.state_dicts()`` as numpy, the form a JAX collection's
    ``load_state_dicts`` takes."""
    return {name: _numpy(state) for name, state in collection.state_dicts().items()}
