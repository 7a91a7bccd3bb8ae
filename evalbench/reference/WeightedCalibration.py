"""Calibration: ``sum(w * prediction) / sum(w * label)``, one task, shape
``(1,)``; ``args`` is ``(predictions, labels)`` or with weights.
"""

import torch

from evalbench.reference._common import div

GAP = "rel"


def reference(args, kwargs, dtype):
    x, y = args[0].to(dtype), args[1].to(dtype)
    w = args[2].to(dtype) if len(args) > 2 else torch.ones_like(x)
    return div((w * x).sum(dtype=dtype), (w * y).sum(dtype=dtype), dtype).reshape(1)
