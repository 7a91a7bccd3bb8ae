"""Device-idle time a pass inside the port, in ms: the gaps in the union
of the device's kernel, copy and memset intervals over the spanned
passes whose middle lies inside a ``collection.*`` span's profiler range
(the rest of the idle time is the caller's: the harness's copies to the
host, its loop) (``evalbench/core/spans.py``)."""

from evalbench.core import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.port_idle_ms
