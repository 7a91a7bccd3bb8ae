"""Click-through rate: ``sum(w * clicks) / sum(w)``, one task, shape
``(1,)``; ``args`` is ``(clicks,)`` or ``(clicks, weights)``.
"""

import torch

from evalbench.reference._common import div

GAP = "rel"


def reference(args, kwargs, dtype):
    clicks = args[0].to(dtype)
    w = args[1].to(dtype) if len(args) > 1 else torch.ones_like(clicks)
    return div((w * clicks).sum(dtype=dtype), w.sum(dtype=dtype), dtype).reshape(1)
