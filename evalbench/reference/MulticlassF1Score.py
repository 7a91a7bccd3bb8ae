"""Macro F1 over ``(N, C)`` scores (the first largest is the prediction)
and ``(N,)`` labels: per class ``2 tp / (predicted + actual)``, averaged
over the classes that are predicted or present.
"""

import torch

from evalbench.reference._common import argmax_first, div

GAP = "rel"


def reference(args, kwargs, dtype):
    scores, target = args
    if kwargs.get("average") != "macro":
        raise NotImplementedError("only the macro average has a reference here")
    c = kwargs["num_classes"]
    pred = argmax_first(scores, dtype)
    tp = torch.bincount(target[pred == target], minlength=c)
    predicted = torch.bincount(pred, minlength=c)
    actual = torch.bincount(target, minlength=c)
    seen = (predicted + actual) > 0
    f1 = torch.where(seen, 2 * tp, 0).to(dtype) / (predicted + actual).clamp(min=1).to(dtype)
    return div(f1.sum(dtype=dtype), seen.sum(), dtype)
