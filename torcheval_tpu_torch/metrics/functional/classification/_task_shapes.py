"""Shape checks shared by the per-task streaming metrics.

JAX counterpart:
``torcheval_tpu/metrics/functional/classification/_task_shapes.py``. One
definition of the "``(num_samples,)`` at ``num_tasks=1``, else
``(num_tasks, num_samples)``" contract, used by normalized entropy, CTR and
calibration, with the JAX package's error strings.
"""

from __future__ import annotations

import torch


def check_task_shape(input: torch.Tensor, num_tasks: int) -> None:
    if num_tasks == 1:
        if input.ndim > 1:
            raise ValueError(
                "`num_tasks = 1`, `input` is expected to be one-dimensional "
                f"tensor, but got shape ({tuple(input.shape)})."
            )
    elif input.ndim == 1 or input.shape[0] != num_tasks:
        raise ValueError(
            f"`num_tasks = {num_tasks}`, `input`'s shape is expected to be "
            f"({num_tasks}, num_samples), but got shape ({tuple(input.shape)})."
        )


def check_num_tasks(num_tasks: int) -> None:
    if num_tasks < 1:
        raise ValueError(
            "`num_tasks` value should be greater than and equal to 1, "
            f"but received {num_tasks}."
        )
