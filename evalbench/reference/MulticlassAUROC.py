"""Macro one-vs-all AUROC over ``(N, C)`` scores and ``(N,)`` labels: each
class's column by rank sums with ties averaged, then the mean over
classes (every class of these configurations has positives and
negatives).
"""

import torch

from evalbench.reference._common import div, rank_sum_auc

GAP = "rel"


def reference(args, kwargs, dtype):
    scores, target = args
    if kwargs.get("average", "macro") != "macro":
        raise NotImplementedError("only the macro average has a reference here")
    c = kwargs["num_classes"]
    s, order = torch.sort(scores.to(dtype).T, dim=1)  # (C, N)
    n = s.shape[1]
    idx = torch.arange(n, device=s.device).expand(c, n)
    starts = torch.ones_like(s, dtype=torch.bool)
    starts[:, 1:] = s[:, 1:] != s[:, :-1]
    ends = torch.ones_like(s, dtype=torch.bool)
    ends[:, :-1] = s[:, :-1] != s[:, 1:]
    first = torch.where(starts, idx, 0).cummax(dim=1).values
    last = torch.where(ends, idx, n).flip(1).cummin(dim=1).values.flip(1)
    pos = target[order] == torch.arange(c, device=s.device)[:, None]
    rank2 = torch.where(pos, first + last + 2, 0).sum(dim=1)
    n_pos = pos.sum(dim=1)
    per_class = rank_sum_auc(rank2, n_pos, n - n_pos, dtype)
    return div(per_class.to(dtype).sum(dtype=dtype), c, dtype)
