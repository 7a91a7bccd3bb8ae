"""Sort-based binary ROC / PR curve functions.

JAX counterpart: ``torcheval_tpu/ops/curves.py`` (binary part; the names are
kept so each function's twin is easy to find, and a ``_kernel`` suffix here
names a plain PyTorch function, not a CUDA kernel).

Scores sort descending with the counts carried along, and cumulative TP/FP
counts are taken in int32. Every position then takes the cumulative counts
of the last row of its tie group (by group id, ``ops/summary.py::group_value``),
so points inside a tie group coincide with the group end: the trapezoid
gets zero-width segments inside a group and the tie diagonal across it, and
the step integral gets zero delta-TP inside a group. Rows with a NaN score
are padding: they sort last, never join a tie group, and carry zero counts.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torcheval_tpu_torch.ops.summary import group_value, sort_descending, tie_groups


def _propagate_group_ends(
    s: torch.Tensor, ctp: torch.Tensor, cfp: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace each position's cumulative counts with those at the END of
    its tie group (the JAX package's reverse ``cummin`` over the
    group-end-masked cumsums; here a scatter and gather by group id, see
    ``ops/summary.py::group_value``)."""
    gid, _, last = tie_groups(s)
    return group_value(gid, last, ctp), group_value(gid, last, cfp)


def _group_end_cumsums(input: torch.Tensor, target: torch.Tensor):
    """Raw samples (unit counts): only the target rides the sort, and the
    FP cumsum is ``rank + 1 - cumsum(tp)``."""
    s, (t,) = sort_descending(input, target.to(torch.int32))
    ctp = torch.cumsum(t, 0, dtype=torch.int32)
    cfp = torch.arange(1, s.shape[0] + 1, dtype=torch.int32, device=s.device) - ctp
    return _propagate_group_ends(s, ctp, cfp)


def _group_end_count_cumsums(
    scores: torch.Tensor, tp_w: torch.Tensor, fp_w: torch.Tensor
):
    """(score, tp_count, fp_count) rows: a raw sample is the unit case
    ``(s, t, 1 - t)``; a summary row carries aggregated counts. int32
    cumulative counts are exact while total positives and negatives each
    stay below 2^31."""
    s, (tp_c, fp_c) = sort_descending(
        scores, tp_w.to(torch.int32), fp_w.to(torch.int32)
    )
    ctp = torch.cumsum(tp_c, 0, dtype=torch.int32)
    cfp = torch.cumsum(fp_c, 0, dtype=torch.int32)
    return _propagate_group_ends(s, ctp, cfp)


def _auroc_from_group_ends(itp: torch.Tensor, ifp: torch.Tensor) -> torch.Tensor:
    """Trapezoidal integration over group-end TP/FP counts; 0.5 when the
    targets are all one or all zero."""
    zero = torch.zeros(1, dtype=torch.int32, device=itp.device)
    tp = torch.cat([zero, itp]).to(torch.float32)
    fp = torch.cat([zero, ifp]).to(torch.float32)
    factor = tp[-1] * fp[-1]
    auc = torch.trapezoid(tp, fp)
    return torch.where(factor == 0, 0.5, auc / torch.clamp(factor, min=1.0))


def _auprc_from_group_ends(itp: torch.Tensor, ifp: torch.Tensor) -> torch.Tensor:
    """Average precision (step integration) over group-end TP/FP counts:
    ``sum(delta_tp * precision) / tp_total``; 0.0 with no positives."""
    tp = itp.to(torch.float32)
    fp = ifp.to(torch.float32)
    precision = tp / torch.clamp(tp + fp, min=1.0)
    delta_tp = torch.diff(itp, prepend=itp.new_zeros(1)).to(torch.float32)
    total = tp[-1]
    ap = torch.sum(delta_tp * precision) / torch.clamp(total, min=1.0)
    return torch.where(total == 0, 0.0, ap)


def binary_auroc_counts_kernel(scores, tp_w, fp_w) -> torch.Tensor:
    """Exact trapezoidal AUROC over (score, tp_count, fp_count) rows."""
    tp, fp = _group_end_count_cumsums(scores, tp_w, fp_w)
    return _auroc_from_group_ends(tp, fp)


def binary_auprc_counts_kernel(scores, tp_w, fp_w) -> torch.Tensor:
    """Average precision over (score, tp, fp) count rows."""
    if scores.shape[0] == 0:
        return torch.tensor(0.0, device=scores.device)
    tp, fp = _group_end_count_cumsums(scores, tp_w, fp_w)
    return _auprc_from_group_ends(tp, fp)


def binary_auroc_counts_presorted_kernel(scores, tp_w, fp_w) -> torch.Tensor:
    """AUROC over rows ALREADY sorted descending, tie-merged and
    (NaN, 0, 0)-padded, as every ``compact_counts`` output is: each row is
    its own tie group, so the cumsums feed the trapezoid with no sort."""
    if scores.shape[0] == 0:
        return torch.tensor(0.5, device=scores.device)
    ctp = torch.cumsum(tp_w, 0, dtype=torch.int32)
    cfp = torch.cumsum(fp_w, 0, dtype=torch.int32)
    return _auroc_from_group_ends(ctp, cfp)


def binary_auprc_counts_presorted_kernel(scores, tp_w, fp_w) -> torch.Tensor:
    """Average precision over presorted tie-merged count rows."""
    if scores.shape[0] == 0:
        return torch.tensor(0.0, device=scores.device)
    ctp = torch.cumsum(tp_w, 0, dtype=torch.int32)
    cfp = torch.cumsum(fp_w, 0, dtype=torch.int32)
    return _auprc_from_group_ends(ctp, cfp)


def binary_auroc_kernel(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Exact trapezoidal AUROC on raw samples."""
    tp, fp = _group_end_cumsums(input, target)
    return _auroc_from_group_ends(tp, fp)


def binary_auprc_kernel(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Average precision on raw samples."""
    if input.shape[0] == 0:
        return torch.tensor(0.0, device=input.device)
    tp, fp = _group_end_cumsums(input, target)
    return _auprc_from_group_ends(tp, fp)
