"""The hand kernels' share of their roofline, in %: the bytes their
launches move a pass by the program's own byte models (the counter
``obs.cost.launch_bytes{entry=}``, each input read once and each output
written once), over the card's peak memory bandwidth
(``evalbench/core/peaks.py``), over their device time a pass (the kernels
``hand_kernel_ms_per_pass`` names), both over the spanned passes
(``evalbench/core/spans.py``)."""

from evalbench.core import spans
from evalbench.core.peaks import hbm_bytes_per_s
from evalbench.core.spec import Spec

HAND = Spec().module("layer_metrics", "hand_kernel_ms_per_pass").HAND


def read(run):
    s = spans.of(run)
    bw = hbm_bytes_per_s(run.device_name)
    if s is None or bw is None or not s.launch_bytes:
        return None
    busy = sum(sec for name, sec in s.by_name.items() if HAND.search(name)) / s.passes
    if busy <= 0:
        return None
    return 100.0 * s.launch_bytes / bw / busy
