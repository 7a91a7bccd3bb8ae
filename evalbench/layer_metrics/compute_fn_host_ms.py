"""The host time a pass in the metrics' terminal computes, in ms, median
over the spanned passes: the deferring members' ``deferred.compute_fn/*``
spans inside the window step and the eager members' ``metric.compute/*``
(the outermost of either), from the program's obs ring
(``evalbench/core/spans.py``)."""

import statistics

from evalbench.core import spans


def read(run):
    s = spans.of(run)
    if s is None or s.compute_fn_host_ms is None:
        return None
    return statistics.median(s.compute_fn_host_ms) * 1e3
