"""Mean squared error.

JAX counterpart:
``torcheval_tpu/metrics/functional/regression/mean_squared_error.py``. The
sufficient statistics are a per-output float32 ``sum_squared_error`` and a
``sum_weight`` that is an int32 count while updates are unweighted (exact to
2^31 samples) and a float32 sum of weights otherwise; both merge by sum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.utils.convert import as_tensor


def _mean_squared_error_param_check(multioutput: str) -> None:
    if multioutput not in ("raw_values", "uniform_average"):
        raise ValueError(
            "The `multioutput` must be either `raw_values` or `uniform_average`, "
            f"got multioutput={multioutput}."
        )


def _mean_squared_error_update_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
    sample_weight: Optional[torch.Tensor],
) -> None:
    if input.ndim >= 3 or target.ndim >= 3:
        raise ValueError(
            "The dimension `input` and `target` should be 1D or 2D, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same size, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if sample_weight is not None:
        if sample_weight.ndim != 1:
            raise ValueError(
                "The `sample_weight` should be a one-dimensional tensor of "
                f"shape (n_sample,), got shape {tuple(sample_weight.shape)}."
            )
        if target.shape[0] != sample_weight.shape[0]:
            raise ValueError(
                "The first dimension of `input`, `target` and `sample_weight` should "
                f"be the same size, got shapes {tuple(input.shape)}, "
                f"{tuple(target.shape)} and {tuple(sample_weight.shape)}."
            )


def _mse_fold(input: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    squared_error = torch.square(target.to(torch.float32) - input.to(torch.float32))
    sum_weight = torch.full((), target.shape[0], dtype=torch.int32, device=target.device)
    return torch.sum(squared_error, dim=0), sum_weight


def _mse_fold_weighted(
    input: torch.Tensor, target: torch.Tensor, sample_weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    squared_error = torch.square(target.to(torch.float32) - input.to(torch.float32))
    w = sample_weight.to(torch.float32)
    if squared_error.ndim == 2:
        squared_error = squared_error * w[:, None]
    else:
        squared_error = squared_error * w
    return torch.sum(squared_error, dim=0), torch.sum(w)


def _mean_squared_error_update(
    input: torch.Tensor,
    target: torch.Tensor,
    sample_weight: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    _mean_squared_error_update_input_check(input, target, sample_weight)
    if sample_weight is None:
        return _mse_fold(input, target)
    return _mse_fold_weighted(input, target, sample_weight)


def _mean_squared_error_compute(
    sum_squared_error: torch.Tensor, multioutput: str, sum_weight: torch.Tensor
) -> torch.Tensor:
    raw_values = sum_squared_error / sum_weight
    if multioutput == "raw_values":
        return raw_values
    return torch.mean(raw_values)


def mean_squared_error(
    input,
    target,
    *,
    sample_weight=None,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    """Mean squared error of ``input`` against ``target``, shape
    ``(n_sample,)`` or ``(n_sample, n_output)``, with optional per-sample
    weights ``(n_sample,)``; ``multioutput`` is ``"uniform_average"`` (mean
    over outputs) or ``"raw_values"``. Runs where the inputs are."""
    _mean_squared_error_param_check(multioutput)
    input, target = as_tensor(input), as_tensor(target)
    if sample_weight is not None:
        sample_weight = as_tensor(sample_weight, input.device)
    sum_squared_error, sum_weight = _mean_squared_error_update(input, target, sample_weight)
    return _mean_squared_error_compute(sum_squared_error, multioutput, sum_weight)
