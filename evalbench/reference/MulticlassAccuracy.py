"""Micro top-k accuracy over ``(N, C)`` scores and ``(N,)`` labels. At
``k = 1`` a row is right when its first largest score is the label's; at
``k > 1`` when fewer than ``k`` scores exceed the label's.
"""

import torch

from evalbench.reference._common import argmax_first, div

GAP = "rel"


def reference(args, kwargs, dtype):
    scores, target = args
    if kwargs.get("average", "micro") != "micro":
        raise NotImplementedError("only the micro average has a reference here")
    k = kwargs.get("k", 1)
    if k == 1:
        right = argmax_first(scores, dtype) == target
    else:
        s = scores.to(dtype)
        true = s.gather(1, target.to(torch.int64)[:, None])
        right = (s > true).sum(dim=1) < k
    return div(right.sum(), target.numel(), dtype)
