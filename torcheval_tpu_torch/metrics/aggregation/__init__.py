"""Aggregation metric classes. JAX counterpart:
``torcheval_tpu/metrics/aggregation/__init__.py``."""

from torcheval_tpu_torch.metrics.aggregation.cat import Cat
from torcheval_tpu_torch.metrics.aggregation.max import Max
from torcheval_tpu_torch.metrics.aggregation.mean import Mean
from torcheval_tpu_torch.metrics.aggregation.min import Min
from torcheval_tpu_torch.metrics.aggregation.quantile import Quantile
from torcheval_tpu_torch.metrics.aggregation.sum import Sum
from torcheval_tpu_torch.metrics.aggregation.throughput import Throughput

__all__ = ["Cat", "Max", "Mean", "Min", "Quantile", "Sum", "Throughput"]
