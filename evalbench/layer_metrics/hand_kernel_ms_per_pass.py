"""Device time of the port's four hand kernels a pass, in ms, by kernel
name in the profiler's trace: ``csrc/hist.cu`` (hist_kernel),
``csrc/scatter.cu`` (segment_sum_kernel), ``csrc/stream_compact.cu``
(compact_kernel) and ``csrc/topk.cu`` (row_kernel, long_kernel), all in
an anonymous namespace."""

import re

HAND = re.compile(r"\(anonymous namespace\)::(hist_kernel|segment_sum_kernel|compact_kernel|row_kernel|long_kernel)\b")


def read(run):
    t = run.trace
    if t is None:
        return None
    s = sum(sec for name, sec in t.by_name.items() if HAND.search(name))
    return s / t.passes * 1e3 if s > 0 else None
