"""Binary normalized (cross-)entropy.

JAX counterpart:
``torcheval_tpu/metrics/functional/classification/binary_normalized_entropy.py``.
NE is the observed cross entropy over the entropy of the base positive
rate, the standard calibration metric of click-through prediction. Its
sufficient statistics per task, ``total_entropy``, ``num_examples`` and
``num_positive``, all merge by sum. They accumulate in float32, as in the
JAX package (the reference accumulates in float64).

The ``[0, 1]`` probability check reads the input's values, so it runs only
on a host-resident source (``utils/tracing.py::host_resident``): a CUDA
batch is never read back for validation, and the clamp of the log terms
keeps the math finite either way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from torcheval_tpu_torch.metrics.functional.classification._task_shapes import (
    check_task_shape,
)
from torcheval_tpu_torch.utils.convert import as_tensor
from torcheval_tpu_torch.utils.tracing import host_resident

_EPS = 1.1920929e-07  # float32 eps, the JAX package's clamp


def _ne_value_check(source, from_logits: bool) -> None:
    """The ``[0, 1]`` probability check, against a host-resident value
    source only (the caller's raw input, or a CPU tensor)."""
    if from_logits or source is None or not host_resident(source):
        return
    arr = np.asarray(source)
    if arr.size and (arr.max() > 1.0 or arr.min() < 0.0):
        raise ValueError(
            f"`from_logits`={from_logits}, `input` should be probability "
            f"in range [0., 1.], but got `input` ranging from {arr.min()} "
            f"to {arr.max()}. Please set `from_logits = True` or convert "
            "`input` into valid probability value."
        )


def _ne_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
    from_logits: bool,
    num_tasks: int,
    weight: Optional[torch.Tensor] = None,
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            f"`input` shape ({tuple(input.shape)}) is different from `target` shape "
            f"({tuple(target.shape)})"
        )
    if weight is not None and input.shape != weight.shape:
        raise ValueError(
            f"`weight` shape ({tuple(weight.shape)}) is different from `input` shape "
            f"({tuple(input.shape)})"
        )
    check_task_shape(input, num_tasks)


def _ne_fold(
    input: torch.Tensor,
    target: torch.Tensor,
    from_logits: bool,
    weight: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    input = input.to(torch.float32)
    target = target.to(torch.float32)
    if from_logits:
        # stable BCE with logits: softplus(x) - x * z
        ce = F.softplus(input) - input * target
    else:
        # binary cross entropy clamps its log terms at -100
        ce = -(
            target * torch.clamp(torch.log(input), min=-100.0)
            + (1.0 - target) * torch.clamp(torch.log1p(-input), min=-100.0)
        )
    if weight is not None:
        w = weight.to(torch.float32)
        ce = ce * w
    else:
        w = torch.ones_like(target)
    return torch.sum(ce, dim=-1), torch.sum(w * target, dim=-1), torch.sum(w, dim=-1)


def _binary_normalized_entropy_update(
    input: torch.Tensor,
    target: torch.Tensor,
    from_logits: bool,
    num_tasks: int,
    weight: Optional[torch.Tensor] = None,
    *,
    value_check_source=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _ne_input_check(input, target, from_logits, num_tasks, weight)
    # the caller's raw input when given: ``input`` is placed by now
    _ne_value_check(
        value_check_source if value_check_source is not None else input, from_logits
    )
    return _ne_fold(input, target, from_logits, weight)


def _baseline_entropy(num_positive: torch.Tensor, num_examples: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(num_positive / num_examples, _EPS, 1.0 - _EPS)
    return -p * torch.log(p) - (1.0 - p) * torch.log(1.0 - p)


def binary_normalized_entropy(
    input,
    target,
    *,
    weight=None,
    num_tasks: int = 1,
    from_logits: bool = False,
) -> torch.Tensor:
    """Normalized binary cross entropy, the observed cross entropy over the
    base rate's entropy, of probabilities ``input`` (logits with
    ``from_logits=True``) and binary labels ``target``, shape
    ``(num_samples,)`` or ``(num_tasks, num_samples)``, with optional
    rescaling weights of the same shape. Runs where ``input`` is."""
    raw_input = input
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    if weight is not None:
        weight = as_tensor(weight, input.device)
    cross_entropy, num_positive, num_examples = _binary_normalized_entropy_update(
        input, target, from_logits, num_tasks, weight, value_check_source=raw_input
    )
    return (cross_entropy / num_examples) / _baseline_entropy(num_positive, num_examples)
