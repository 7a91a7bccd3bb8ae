"""``MetricCollection``: several metrics driven by the same update arguments.

JAX counterpart: ``torcheval_tpu/metrics/collection.py`` (``MetricCollection``
without its evaluation window). The JAX collection appends each batch once
to a window shared by its deferred members and folds and computes them all
in one program. PyTorch runs eagerly, so here each batch is placed on the
metrics' device once and handed to every member's ``update``, which folds
it at once; results, ``reset`` and the state dicts are the JAX
collection's.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from torcheval_tpu_torch.metrics.metric import Metric


def _placeable(x: Any) -> bool:
    """Tensors and arrays are placed once for the whole collection; Python
    scalars and other objects go to the members as they are."""
    return isinstance(x, (torch.Tensor, np.ndarray))


class MetricCollection:
    """Drive several metrics with identical ``update(*args, **kwargs)``.

    Example::

        col = MetricCollection({
            "acc": MulticlassAccuracy(num_classes=1000),
            "mse": MeanSquaredError(),
        })
        for scores, labels in loader:
            col.update(scores, labels)
        results = col.compute()      # {"acc": ..., "mse": ...}

    A single metric (not a dict) makes ``compute()`` return its result
    alone. Build separate collections for metrics fed from different
    tensors.
    """

    def __init__(self, metrics: Union[Metric, Dict[str, Metric]]) -> None:
        self._single = isinstance(metrics, Metric)
        self.metrics: Dict[str, Metric] = (
            {"metric": metrics} if self._single else dict(metrics)
        )
        if not self.metrics:
            raise ValueError("MetricCollection needs at least one metric.")
        # place each batch once, on the first member's device
        self._place = next(iter(self.metrics.values()))._input

    def update(self, *args: Any, **kwargs: Any) -> "MetricCollection":
        args = tuple(self._place(a) if _placeable(a) else a for a in args)
        kwargs = {k: self._place(v) if _placeable(v) else v for k, v in kwargs.items()}
        for m in self.metrics.values():
            m.update(*args, **kwargs)
        return self

    def compute(self) -> Any:
        out = {n: m.compute() for n, m in self.metrics.items()}
        return out["metric"] if self._single else out

    def reset(self) -> "MetricCollection":
        for m in self.metrics.values():
            m.reset()
        return self

    def state_dicts(self) -> Dict[str, Dict[str, Any]]:
        return {n: m.state_dict() for n, m in self.metrics.items()}

    def load_state_dicts(
        self, state_dicts: Dict[str, Dict[str, Any]], strict: bool = True
    ) -> "MetricCollection":
        """Install per-member state dicts (the inverse of
        :meth:`state_dicts`). ``strict`` requires the member names to match
        exactly and is passed on to each member's ``load_state_dict``."""
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
        return f"{type(self).__name__}({', '.join(self.metrics)})"
