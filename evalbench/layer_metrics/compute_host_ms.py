"""The median over the window's passes of the host time of the pass's
``compute()`` calls until every value is on the host, in ms."""

import statistics


def read(run):
    if not run.compute_s:
        return None
    return statistics.median(run.compute_s) * 1e3
