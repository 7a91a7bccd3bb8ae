"""Carrying metric state between the JAX package and this port.

JAX counterpart: none; this is the bridge between ``torcheval_tpu`` metrics
and their twins here. Both packages' ``state_dict()`` hold the same names,
shapes and dtypes, so a stream can start in one package and finish in the
other. The JAX side's ``state_dict()`` turned into numpy
(``{name: np.asarray(v)}``, lists element by element) loads here through
:func:`load_jax_state_dict`; :func:`numpy_state_dict` gives this side's
state in the numpy form the JAX side's ``load_state_dict`` takes. Neither
function imports JAX.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Union

import numpy as np
import torch

from torcheval_tpu_torch.metrics.metric import Metric

NumpyState = Dict[str, Union[np.ndarray, List[np.ndarray]]]


def _to_tensor(v: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(v))


def load_jax_state_dict(metric: Metric, state: NumpyState, strict: bool = True) -> None:
    """Install a JAX metric's state (as numpy arrays, or lists of them) into
    ``metric``, its twin in this package, on ``metric``'s device."""
    converted: Dict[str, Any] = {}
    for name, value in state.items():
        if isinstance(value, (list, tuple, deque)):
            converted[name] = [_to_tensor(v) for v in value]
        elif isinstance(value, dict):
            converted[name] = {k: _to_tensor(v) for k, v in value.items()}
        else:
            converted[name] = _to_tensor(value)
    metric.load_state_dict(converted, strict=strict)


def numpy_state_dict(metric: Metric) -> NumpyState:
    """``metric.state_dict()`` as numpy arrays (lists stay lists), the form
    a JAX metric's ``load_state_dict`` takes."""
    out: Dict[str, Any] = {}
    for name, value in metric.state_dict().items():
        if isinstance(value, (list, deque)):
            out[name] = [v.cpu().numpy() for v in value]
        elif isinstance(value, dict):
            out[name] = {k: v.cpu().numpy() for k, v in value.items()}
        else:
            out[name] = value.cpu().numpy()
    return out
