"""The 90th percentile of one pass's time over all passes of the window,
in ms: from the pass's ``reset()`` to ``compute()``'s values on the host.
Linear between order statistics (``statistics.quantiles``, inclusive)."""

import statistics


def read(run):
    if len(run.pass_s) == 1:
        return run.pass_s[0] * 1e3
    return statistics.quantiles(run.pass_s, n=10, method="inclusive")[8] * 1e3
