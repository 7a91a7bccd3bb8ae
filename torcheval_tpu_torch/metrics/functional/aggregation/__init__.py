"""Functional aggregations. JAX counterpart:
``torcheval_tpu/metrics/functional/aggregation/__init__.py``."""

from torcheval_tpu_torch.metrics.functional.aggregation.mean import mean
from torcheval_tpu_torch.metrics.functional.aggregation.sum import sum  # noqa: A004

__all__ = ["mean", "sum"]
