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
where the other package left it.

Model weights carry from flax to ``torch.nn`` layers the same way, as numpy
arrays: :func:`flax_dense_kernel` turns a ``Dense`` kernel ``(in, out)``
into a ``Linear.weight`` ``(out, in)``, :func:`flax_conv_kernel` a ``Conv``
kernel HWIO into OIHW, and :func:`load_flax_params` loads a whole model from
``(torch module name, flax module path)`` pairs; biases carry as they are.
None of these functions imports JAX.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Mapping, Sequence, Tuple, Union

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


def flax_dense_kernel(kernel: np.ndarray) -> torch.Tensor:
    """A flax ``Dense`` kernel ``(in, out)`` as a ``Linear.weight``
    ``(out, in)``."""
    return torch.from_numpy(np.array(np.asarray(kernel).T, order="C"))


def flax_conv_kernel(kernel: np.ndarray) -> torch.Tensor:
    """A flax ``Conv`` kernel ``(*spatial, in, out)`` (HWIO in 2-D) as a
    ``ConvNd.weight`` ``(out, in, *spatial)`` (OIHW)."""
    return torch.from_numpy(np.array(np.moveaxis(np.asarray(kernel), (-1, -2), (0, 1)), order="C"))


def load_flax_params(
    module: torch.nn.Module,
    params: Mapping[str, Any],
    pairs: Sequence[Tuple[str, Tuple[str, ...]]],
) -> None:
    """Load flax parameters (the ``params`` collection as nested dicts of
    numpy arrays) into ``module``. Each pair names a ``Linear`` or ``ConvNd``
    submodule of ``module`` and the path of its flax ``Dense`` or ``Conv`` in
    ``params``: the kernel goes into ``weight`` (a 2-D kernel as a
    ``Dense``'s, a longer one as a ``Conv``'s), the bias into ``bias``. Raises
    ``ValueError`` when a shape or a bias does not match."""
    for torch_name, flax_path in pairs:
        layer = module.get_submodule(torch_name)
        node = params
        for key in flax_path:
            node = node[key]
        kernel = np.asarray(node["kernel"])
        weight = flax_dense_kernel(kernel) if kernel.ndim == 2 else flax_conv_kernel(kernel)
        values = {"weight": weight}
        if ("bias" in node) != (getattr(layer, "bias", None) is not None):
            raise ValueError(f"{torch_name} and {'/'.join(flax_path)} disagree on a bias")
        if "bias" in node:
            values["bias"] = torch.from_numpy(np.array(node["bias"]))
        for name, value in values.items():
            target = getattr(layer, name)
            if tuple(target.shape) != tuple(value.shape):
                raise ValueError(
                    f"{torch_name}.{name} has shape {tuple(target.shape)}; "
                    f"{'/'.join(flax_path)} gives {tuple(value.shape)}"
                )
            with torch.no_grad():
                target.copy_(value)
