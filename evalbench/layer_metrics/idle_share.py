"""The share of the traced window in which nothing ran on the device, in
%: 1 - busy / window, both from the profiler's trace."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
