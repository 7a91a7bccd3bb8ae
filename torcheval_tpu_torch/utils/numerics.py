"""Small numeric helpers. JAX counterpart: ``torcheval_tpu/utils/numerics.py``."""

from __future__ import annotations

import torch


def safe_div(num: torch.Tensor, den: torch.Tensor, *, fill: float = 0.0) -> torch.Tensor:
    """``num / den`` with ``fill`` where ``den == 0``. The guarded
    denominator keeps the untaken division from producing inf or NaN."""
    zero = den == 0
    return torch.where(zero, fill, num / torch.where(zero, 1.0, den))
