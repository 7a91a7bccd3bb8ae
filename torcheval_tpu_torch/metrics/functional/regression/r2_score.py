"""R-squared score.

JAX counterpart: ``torcheval_tpu/metrics/functional/regression/r2_score.py``.
The streaming form keeps four sufficient statistics per output,
``sum(y^2)``, ``sum(y)``, ``sum((y - yhat)^2)`` and the int32 count ``n``,
all merged by sum. The total sum of squares is recovered at compute as
``sum(y^2) - sum(y)^2 / n``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torcheval_tpu_torch.utils.convert import as_tensor


def _r2_score_param_check(multioutput: str, num_regressors: int) -> None:
    if multioutput not in ("raw_values", "uniform_average", "variance_weighted"):
        raise ValueError(
            "The `multioutput` must be either `raw_values` or `uniform_average` "
            f"or `variance_weighted`, got multioutput={multioutput}."
        )
    if not isinstance(num_regressors, int) or num_regressors < 0:
        raise ValueError(
            "The `num_regressors` must an integer larger or equal to zero, "
            f"got num_regressors={num_regressors}."
        )


def _r2_score_update_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
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


def _r2_fold(
    input: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    target = target.to(torch.float32)
    input = input.to(torch.float32)
    sum_squared_obs = torch.sum(torch.square(target), dim=0)
    sum_obs = torch.sum(target, dim=0)
    sum_squared_residual = torch.sum(torch.square(target - input), dim=0)
    # an int32 count: exact to 2^31 samples (float32 stalls at 2^24)
    num_obs = torch.full((), target.shape[0], dtype=torch.int32, device=target.device)
    return sum_squared_obs, sum_obs, sum_squared_residual, num_obs


def _r2_score_update(
    input: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    _r2_score_update_input_check(input, target)
    return _r2_fold(input, target)


def _r2_score_compute(
    sum_squared_obs: torch.Tensor,
    sum_obs: torch.Tensor,
    rss: torch.Tensor,
    num_obs: torch.Tensor,
    multioutput: str,
    num_regressors: int,
) -> torch.Tensor:
    """The score from the statistics; reads ``num_obs`` on the host for the
    insufficient-data errors, as the JAX package does."""
    n = float(num_obs)
    if n < 2:
        raise ValueError(
            "There is no enough data for computing. Needs at least two samples "
            "to calculate r2 score."
        )
    if num_regressors >= n - 1:
        raise ValueError(
            "The `num_regressors` must be smaller than n_samples - 1, "
            f"got num_regressors={num_regressors}, n_samples={n}.",
        )
    tss = sum_squared_obs - torch.square(sum_obs) / num_obs
    r_squared = 1 - (rss / tss)
    if multioutput == "uniform_average":
        r_squared = torch.mean(r_squared)
    elif multioutput == "variance_weighted":
        r_squared = torch.sum(r_squared * tss / torch.sum(tss))
    if num_regressors != 0:
        r_squared = 1 - (1 - r_squared) * (num_obs - 1) / (num_obs - num_regressors - 1)
    return r_squared


def r2_score(
    input,
    target,
    *,
    multioutput: str = "uniform_average",
    num_regressors: int = 0,
) -> torch.Tensor:
    """The R-squared score (coefficient of determination) of ``input``
    against ``target``, shape ``(n_sample,)`` or ``(n_sample, n_output)``;
    ``multioutput`` is ``"uniform_average"``, ``"raw_values"`` or
    ``"variance_weighted"``, and ``num_regressors`` (0: plain R^2) gives the
    adjusted score. Runs where ``input`` is."""
    _r2_score_param_check(multioutput, num_regressors)
    input = as_tensor(input)
    target = as_tensor(target, input.device)
    sum_squared_obs, sum_obs, sum_squared_residual, num_obs = _r2_score_update(input, target)
    return _r2_score_compute(
        sum_squared_obs, sum_obs, sum_squared_residual, num_obs, multioutput, num_regressors
    )
