"""BinaryNormalizedEntropy.

JAX counterpart:
``torcheval_tpu/metrics/classification/binary_normalized_entropy.py``.
Updates are deferred (``metrics/deferred.py``): ``update()`` runs the shape
checks and the ``[0, 1]`` value check (on the caller's raw input, and only
when it is host-resident, so per update and never inside a fold), and
appends the placed batch; the entropy fold runs over the pending batches
at the next read of the state, or at the memory valve.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.functional.classification._task_shapes import check_num_tasks
from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _baseline_entropy,
    _ne_fold,
    _ne_input_check,
    _ne_value_check,
)
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.utils.devices import DeviceLike

_STATE_NAMES = ("total_entropy", "num_examples", "num_positive")


# The optional weight defers as a third column, so the trailing parameters
# are read by arity: rest is (from_logits,) or (weight, from_logits).
def _ne_deferred_fold(input, target, *rest):
    if len(rest) == 2:
        weight, from_logits = rest
    else:
        weight, from_logits = None, rest[0]
    cross_entropy, num_positive, num_examples = _ne_fold(input, target, from_logits, weight)
    return {
        "total_entropy": cross_entropy,
        "num_examples": num_examples,
        "num_positive": num_positive,
    }


class BinaryNormalizedEntropy(DeferredFoldMixin, Metric[torch.Tensor]):
    """Streaming normalized binary cross entropy, the calibration metric of
    click-through prediction, with state of shape ``(num_tasks,)``;
    ``from_logits`` reads the inputs as logits. Accumulates in float32, as
    the JAX package does (the reference uses float64)."""

    _fold_fn = staticmethod(_ne_deferred_fold)
    _fold_per_chunk = True

    def __init__(
        self,
        *,
        from_logits: bool = False,
        num_tasks: int = 1,
        device: DeviceLike = None,
    ) -> None:
        super().__init__(device=device)
        self.from_logits = from_logits
        check_num_tasks(num_tasks)
        self.num_tasks = num_tasks
        for name in _STATE_NAMES:
            self._add_state(name, zeros_state((num_tasks,)), reduction=Reduction.SUM)
        self._init_deferred()
        self._fold_params = (from_logits,)

    def update(
        self, input, target, *, weight: Optional[torch.Tensor] = None
    ) -> "BinaryNormalizedEntropy":
        raw_input = input
        input, target = self._input(input), self._input(target)
        if weight is not None:
            weight = self._input(weight)
        _ne_input_check(input, target, self.from_logits, self.num_tasks, weight)
        _ne_value_check(raw_input, self.from_logits)
        if weight is None:
            self._defer(input, target)
        else:
            self._defer(input, target, weight)
        return self

    def compute(self) -> torch.Tensor:
        """The per-task NE; an empty tensor while some task has no example
        (a read of ``num_examples`` on the host, as in the JAX package)."""
        self._fold_now()
        if bool((self.num_examples == 0.0).any()):
            return torch.empty((0,), device=self._device)
        baseline = _baseline_entropy(self.num_positive, self.num_examples)
        return (self.total_entropy / self.num_examples) / baseline

    def merge_state(
        self, metrics: Iterable["BinaryNormalizedEntropy"]
    ) -> "BinaryNormalizedEntropy":
        for metric in self._fold_for_merge(metrics):
            for name in _STATE_NAMES:
                setattr(self, name, getattr(self, name) + getattr(metric, name).to(self._device))
        return self
