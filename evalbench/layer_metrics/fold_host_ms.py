"""The host time a pass in the deferred folds, in ms, median over the
spanned passes: the program's ``deferred.operands`` (the window's stacks
and concatenations) and ``deferred.fold/*`` spans (each member's
``_fold_fn`` calls and its combine into state), from its obs ring
(``evalbench/core/spans.py``)."""

import statistics

from evalbench.core import spans


def read(run):
    s = spans.of(run)
    if s is None or s.fold_host_ms is None:
        return None
    return statistics.median(s.fold_host_ms) * 1e3
