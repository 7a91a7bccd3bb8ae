"""Functional regression metrics. JAX counterpart:
``torcheval_tpu/metrics/functional/regression/__init__.py`` (mean squared
error so far)."""

from torcheval_tpu_torch.metrics.functional.regression.mean_squared_error import (
    mean_squared_error,
)

__all__ = ["mean_squared_error"]
