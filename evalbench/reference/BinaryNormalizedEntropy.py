"""Normalized entropy: the mean binary cross entropy over the entropy of
the base rate (He et al., "Practical Lessons from Predicting Clicks on Ads
at Facebook", 2014). One task, unweighted; ``from_logits`` reads the
scores as logits. Shape ``(1,)``.
"""

import torch

from evalbench.reference._common import div

GAP = "rel"


def reference(args, kwargs, dtype):
    x, y = (a.to(dtype) for a in args[:2])
    if kwargs.get("from_logits", False):
        # log(1 + e^x) - x y, written so that no exponent overflows
        ce = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs())) - x * y
    else:
        ce = -(y * torch.clamp(torch.log(x), min=-100) + (1 - y) * torch.clamp(torch.log1p(-x), min=-100))
    n = x.numel()
    mean_ce = div(ce.sum(dtype=dtype), n, dtype)
    p = div(y.sum(dtype=dtype), n, dtype)
    base = -p * torch.log(p) - (1 - p) * torch.log(1 - p)
    return div(mean_ce, base, dtype).reshape(1)
