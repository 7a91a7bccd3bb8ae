"""Binary AUROC by rank sums with ties averaged (Mann-Whitney U), exact.

``args``: scores ``(N,)`` and binary targets ``(N,)``. Sorts the scores
once; each run of equal scores takes the mean of its ranks.
"""

import torch

from evalbench.reference._common import rank_sum_auc

GAP = "rel"


def reference(args, kwargs, dtype):
    scores, target = args
    s, order = torch.sort(scores.to(dtype))
    pos = (target[order] != 0).to(torch.int64)
    n = s.numel()
    _, run, counts = torch.unique_consecutive(s, return_inverse=True, return_counts=True)
    last = torch.cumsum(counts, 0)  # 1-based rank of each run's last row
    first = last - counts + 1
    pos_in_run = torch.zeros(counts.numel(), dtype=torch.int64, device=s.device)
    pos_in_run.index_add_(0, run, pos)
    rank2 = (pos_in_run * (first + last)).sum()
    n_pos = pos.sum()
    return rank_sum_auc(rank2, n_pos, n - n_pos, dtype)
