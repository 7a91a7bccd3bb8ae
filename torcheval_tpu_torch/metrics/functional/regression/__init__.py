"""Functional regression metrics. JAX counterpart:
``torcheval_tpu/metrics/functional/regression/__init__.py``."""

from torcheval_tpu_torch.metrics.functional.regression.mean_squared_error import (
    mean_squared_error,
)
from torcheval_tpu_torch.metrics.functional.regression.r2_score import r2_score

__all__ = ["mean_squared_error", "r2_score"]
