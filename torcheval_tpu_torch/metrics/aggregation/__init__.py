"""Aggregation metric classes. JAX counterpart:
``torcheval_tpu/metrics/aggregation/__init__.py`` (Sum, Mean, Max and Min so
far)."""

from torcheval_tpu_torch.metrics.aggregation.max import Max
from torcheval_tpu_torch.metrics.aggregation.mean import Mean
from torcheval_tpu_torch.metrics.aggregation.min import Min
from torcheval_tpu_torch.metrics.aggregation.sum import Sum

__all__ = ["Max", "Mean", "Min", "Sum"]
