"""The score sketch's fold against its roofline, in %: the fold's least
bytes a pass over the card's peak memory bandwidth
(``evalbench/core/peaks.py``), over its device time a pass
(``sketch_fold_device_ms``). The least bytes are the benchmark's count,
not the program's, so the yardstick stays whatever kernel or fusion does
the fold: the AUROC's two float32 inputs read once (8 bytes a row) and
the ``(tp, fp)`` int32 counts of every bucket written once."""

from evalbench.core.peaks import hbm_bytes_per_s
from evalbench.core.spec import Spec

DEVICE_MS = Spec().module("layer_metrics", "sketch_fold_device_ms")
# approx=True's bucket count, the port's default (torcheval_tpu_torch/sketch/buckets.py)
BUCKETS = 1 << 16


def least_bytes(run) -> int:
    return run.rows_per_pass * (4 + 4) + 2 * BUCKETS * 4


def read(run):
    bw = hbm_bytes_per_s(run.device_name)
    ms = DEVICE_MS.read(run)
    if bw is None or not ms:
        return None
    return 100.0 * least_bytes(run) / bw / (ms / 1e3)
