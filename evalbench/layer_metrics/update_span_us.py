"""The median host time of one ``MetricCollection.update()`` in the
spanned passes, in us: the program's own ``collection.update`` spans, from
its obs ring, with obs on (``evalbench/core/spans.py``). The twin of
``update_host_us``, which the harness's clock takes with obs off."""

import statistics

from evalbench.core import spans


def read(run):
    s = spans.of(run)
    if s is None or not s.update_us:
        return None
    return statistics.median(s.update_us)
