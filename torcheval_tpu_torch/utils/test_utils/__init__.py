"""Test fixtures for metric implementations. JAX counterpart:
``torcheval_tpu/utils/test_utils/__init__.py``."""

from torcheval_tpu_torch.utils.test_utils.dummy_metric import (
    DummySumDequeStateMetric,
    DummySumDictStateMetric,
    DummySumListStateMetric,
    DummySumMetric,
)
from torcheval_tpu_torch.utils.test_utils.metric_class_tester import (
    BATCH_SIZE,
    NUM_PROCESSES,
    NUM_TOTAL_UPDATES,
    MetricClassTester,
    assert_result_close,
)

__all__ = [
    "BATCH_SIZE",
    "NUM_PROCESSES",
    "NUM_TOTAL_UPDATES",
    "MetricClassTester",
    "assert_result_close",
    "DummySumDequeStateMetric",
    "DummySumDictStateMetric",
    "DummySumListStateMetric",
    "DummySumMetric",
]
