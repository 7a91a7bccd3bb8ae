"""Shared arithmetic of the plain references (no metric of its own).

Every reference takes the pass's whole inputs as the harness handed them
to the program and a ``dtype``: float64 for the reference, a lower
precision for the control. Float inputs are cast to ``dtype`` and every
float sum and division is carried out in it; counts stay exact integers.
The result is returned as float64 (int64 for counts).
"""

import torch


def div(num, den, dtype):
    """``num / den`` computed in ``dtype``, returned as float64."""
    num = torch.as_tensor(num).to(dtype)
    den = torch.as_tensor(den, device=num.device).to(dtype)
    return (num / den).to(torch.float64)


def argmax_first(scores, dtype):
    """The predicted class of each row: the first largest score."""
    return torch.argmax(scores.to(dtype), dim=1)


def rank_sum_auc(pos_rank2, n_pos, n_neg, dtype):
    """Mann-Whitney AUC from twice the summed (tie-averaged, 1-based)
    ranks of the positives, an exact integer."""
    num = pos_rank2.to(torch.float64) / 2 - n_pos.to(torch.float64) * (n_pos.to(torch.float64) + 1) / 2
    return div(num, n_pos.to(torch.float64) * n_neg.to(torch.float64), dtype)
