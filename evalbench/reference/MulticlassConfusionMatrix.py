"""The confusion matrix: ``out[t, p]`` counts the rows of label ``t``
whose first largest score is class ``p``; exact int64 counts.
"""

import torch

from evalbench.reference._common import argmax_first

GAP = "exact"


def reference(args, kwargs, dtype):
    scores, target = args
    c = kwargs["num_classes"]
    pred = argmax_first(scores, dtype) if scores.ndim == 2 else scores
    key = target.to(torch.int64) * c + pred.to(torch.int64)
    return torch.bincount(key, minlength=c * c).reshape(c, c)
