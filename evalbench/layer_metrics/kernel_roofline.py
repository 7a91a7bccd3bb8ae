"""The least time of a pass's device work over the device's busy time a
pass, in %. The least time is the bytes handed to ``update()`` in one pass
(each input tensor read once) plus the bytes of ``compute()``'s values,
over the card's peak memory bandwidth (``evalbench/core/peaks.py``). Busy
time is the union of the device's kernel, copy and memset intervals."""

from evalbench.core.peaks import hbm_bytes_per_s


def read(run):
    t = run.trace
    bw = hbm_bytes_per_s(run.device_name)
    if t is None or bw is None or t.busy_s <= 0:
        return None
    least_s = (run.input_bytes + run.output_bytes) / bw
    return 100.0 * least_s / (t.busy_s / t.passes)
