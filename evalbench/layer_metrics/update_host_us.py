"""The median host time of one ``MetricCollection.update()`` call over all
calls of the window, in us (the traced run's host clock)."""

import statistics


def read(run):
    if not run.update_s:
        return None
    return statistics.median(run.update_s) * 1e6
