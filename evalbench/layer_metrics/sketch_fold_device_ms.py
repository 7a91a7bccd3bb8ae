"""Device time a pass launched inside the score sketch's folds, in ms: the
kernels, copies and memsets whose innermost program range is a
``metric.fold/<Class>`` span of an update (the bucket keys, the count
lanes, the NaN mask) or its ``jit/segment_sum`` child (the segment sum
and the zeroing of its output), as shares of the spanned passes' busy
time (``evalbench/core/spans.py``). A fold of leftovers inside a
``compute()`` counts with the compute; the cells that list this metric
fold every row in their update. None where the program has no such span."""

from evalbench.core import spans

FOLD = "metric.fold/"
SHARES = ("collection/" + FOLD, "collection/jit/segment_sum")


def read(run):
    s = spans.of(run)
    if s is None or not s.shares or not any(own.startswith(FOLD) for own, _, _ in s.host_member):
        return None
    share = sum(v for k, v in s.shares.items() if k.startswith(SHARES[0]) or k == SHARES[1])
    return share * s.busy_s / s.passes * 1e3
