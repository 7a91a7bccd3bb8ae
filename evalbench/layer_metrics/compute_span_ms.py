"""The host time of a pass's ``MetricCollection.compute()`` calls in the
spanned passes, in ms, median over passes: the program's own
``collection.compute`` spans (``evalbench/core/spans.py``). The twin of
``compute_host_ms``, whose harness clock also holds the values' copy to
the host."""

import statistics

from evalbench.core import spans


def read(run):
    s = spans.of(run)
    if s is None or s.compute_ms is None:
        return None
    return statistics.median(s.compute_ms) * 1e3
