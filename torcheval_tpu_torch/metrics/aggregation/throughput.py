"""Throughput.

JAX counterpart: ``torcheval_tpu/metrics/aggregation/throughput.py``. The
one metric whose ``update`` takes host scalars, so it never defers: its
states are float32 scalars on the metric's device (for checkpoints and
sync), and an update is two scalar adds.
"""

from __future__ import annotations

import logging
from typing import Iterable

import torch

from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, zeros_state
from torcheval_tpu_torch.utils.devices import DeviceLike
from torcheval_tpu_torch.utils.numerics import safe_div
from torcheval_tpu_torch.utils.tracing import async_value_warn

_logger = logging.getLogger(__name__)


class Throughput(Metric[torch.Tensor]):
    """Items processed per second. A merge sums the counts and takes the
    largest elapsed time of the replicas: in a synchronous program the
    slowest rank sets the throughput."""

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__(device=device)
        self._add_state("num_total", zeros_state(), reduction=Reduction.SUM)
        self._add_state("elapsed_time_sec", zeros_state(), reduction=Reduction.MAX)

    def update(self, num_processed: int, elapsed_time_sec: float) -> "Throughput":
        if num_processed < 0:
            raise ValueError(
                f"Expected num_processed to be a non-negative number, but received {num_processed}."
            )
        if elapsed_time_sec <= 0:
            raise ValueError(
                f"Expected elapsed_time_sec to be a positive number, but received {elapsed_time_sec}."
            )
        self.num_total = self.num_total + num_processed
        self.elapsed_time_sec = self.elapsed_time_sec + elapsed_time_sec
        return self

    def compute(self) -> torch.Tensor:
        # the no-update warning reads the elapsed time on a daemon thread
        def _check(t) -> None:
            if t == 0.0:
                _logger.warning("No calls to update() have been made - returning 0.0")

        async_value_warn(_check, self.elapsed_time_sec)
        return safe_div(self.num_total, self.elapsed_time_sec)

    def merge_state(self, metrics: Iterable["Throughput"]) -> "Throughput":
        for metric in metrics:
            self.num_total = self.num_total + metric.num_total.to(self._device)
            self.elapsed_time_sec = torch.maximum(
                self.elapsed_time_sec, metric.elapsed_time_sec.to(self._device)
            )
        return self
