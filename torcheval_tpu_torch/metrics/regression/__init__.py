"""Regression metric classes. JAX counterpart:
``torcheval_tpu/metrics/regression/__init__.py`` (MeanSquaredError so
far)."""

from torcheval_tpu_torch.metrics.regression.mean_squared_error import MeanSquaredError

__all__ = ["MeanSquaredError"]
