"""The host time of a pass's ``MetricCollection.reset()`` calls in the
spanned passes, in ms, median over passes: the program's own
``collection.reset`` spans (``evalbench/core/spans.py``)."""

import statistics

from evalbench.core import spans


def read(run):
    s = spans.of(run)
    if s is None or s.reset_ms is None:
        return None
    return statistics.median(s.reset_ms) * 1e3
