"""Device time a pass launched inside the terminal computes' spans, in ms:
each kernel, copy and memset of the spanned passes put down to the
innermost program range holding its launch, and counted when that range
or an ancestor is ``deferred.compute_fn/*`` or ``metric.compute/*``
(``evalbench/core/spans.py``)."""

from evalbench.core import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.compute_fn_device_ms
