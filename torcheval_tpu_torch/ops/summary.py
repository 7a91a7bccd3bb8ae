"""Threshold-summary compaction: the bounded-memory path to billion-sample
curves.

JAX counterpart: ``torcheval_tpu/ops/summary.py``. The sufficient statistic
of every threshold curve is, per unique score, the aggregated
(tp_count, fp_count). A summary of (score, tp, fp) rows is bounded by the
stream's score cardinality, not its sample count, and it is exact: the curve
functions in ``ops/curves.py`` give the same result on it as on the raw
samples, because tied scores collapse into one cumsum step either way.

Output contract of both compactions: rows of the input's length, unique rows
first in descending score order, then ``(NaN, 0, 0)`` padding.

Sorting: ``torch.sort(descending=True)`` would put NaN first. Like the JAX
package, every sort here sorts the NEGATED scores ascending, which puts NaN
(the padding) last, behind every real score including ``-inf``.
"""

from __future__ import annotations

from typing import Tuple

import torch

# NaN, not -inf: it sorts behind every real score including -inf (a legal
# score, e.g. log(0) log-probs), and NaN != NaN keeps padding rows out of
# every real tie group. NaN scores are thereby reserved.
PAD_SCORE = float("nan")


def sort_descending(scores: torch.Tensor, *payload: torch.Tensor):
    """``scores`` in descending order with NaN last, and each payload column
    carried along. Sorts ``-scores`` ascending (see the module docstring)."""
    neg, idx = torch.sort(-scores)
    return -neg, [p[idx] for p in payload]


def tie_groups(s: torch.Tensor):
    """``(gid, first, last)`` of a sorted score column: each row's tie-group
    id (int64, from an int32 cumsum of the group-start flags) and the
    group-start and group-end masks. NaN != NaN, so every NaN row is a group
    of its own."""
    n = s.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=s.device)
    last = torch.ones(n, dtype=torch.bool, device=s.device)
    if n:
        first[1:] = s[1:] != s[:-1]
        last[:-1] = first[1:]
    gid = (torch.cumsum(first, 0, dtype=torch.int32) - 1).to(torch.int64)
    return gid, first, last


def group_value(gid: torch.Tensor, at: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Every row gets ``values`` at the one row of its group where ``at`` is
    set (``at`` marks exactly one row per group).

    This stands in for the JAX package's masked ``lax.cummax`` /
    reverse ``lax.cummin`` scans: a scatter into a per-group table and a
    gather back, where PyTorch's 1-D ``cummax``/``cummin`` (which also
    computes indices) measured about 300 ms per 100M rows on the card.
    Unmarked rows scatter into one spare slot past the groups, which is
    never read."""
    n = values.shape[0]
    slots = torch.where(at, gid, n)
    table = values.new_zeros(n + 1)
    table.scatter_(0, slots, values)
    return table[gid]


def group_deltas_sorted(
    s: torch.Tensor, tp_c: torch.Tensor, fp_c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tie-group count aggregation over a stream already sorted
    descending with NaN last.

    Returns ``(delta_tp, delta_fp, keep, nan_dropped)``: summed counts at
    each group's END row (zeros elsewhere), ``keep`` marking group-end rows
    with a nonzero count and a non-NaN score, and ``nan_dropped`` counting
    samples whose score was NaN (their counts are zeroed in the deltas).
    Cumulative sums are int32, as in the JAX package."""
    n = s.shape[0]
    dev = s.device
    if n == 0:
        zero = torch.zeros(0, dtype=torch.int32, device=dev)
        return (
            zero,
            zero.clone(),
            torch.zeros(0, dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
        )
    ctp = torch.cumsum(tp_c, 0, dtype=torch.int32)
    cfp = torch.cumsum(fp_c, 0, dtype=torch.int32)
    gid, first, last = tie_groups(s)
    # cumulative count at the end of the PREVIOUS tie group, which is the
    # exclusive cumsum at this group's first row (the JAX package takes it
    # as a shifted cummax of the group-end-masked cumsum)
    prev_tp = group_value(gid, first, ctp - tp_c)
    prev_fp = group_value(gid, first, cfp - fp_c)
    delta_tp = torch.where(last, ctp - prev_tp, 0)
    delta_fp = torch.where(last, cfp - prev_fp, 0)
    real = last & ((delta_tp > 0) | (delta_fp > 0))
    nan = torch.isnan(s)
    nan_dropped = torch.where(real & nan, delta_tp + delta_fp, 0).sum(
        dtype=torch.int32
    )
    keep = real & ~nan
    delta_tp = torch.where(keep, delta_tp, 0)
    delta_fp = torch.where(keep, delta_fp, 0)
    return delta_tp, delta_fp, keep, nan_dropped


def _sorted_deltas(scores, tp_w, fp_w):
    s, (tp_c, fp_c) = sort_descending(
        scores, tp_w.to(torch.int32), fp_w.to(torch.int32)
    )
    return (s, *group_deltas_sorted(s, tp_c, fp_c))


def compact_counts(scores: torch.Tensor, tp_w: torch.Tensor, fp_w: torch.Tensor):
    """Merge rows with tied scores into one (score, sum tp, sum fp) row each,
    with two sorts: the plain version, and the oracle of
    :func:`compact_counts_fast`.

    Returns ``(scores, tp, fp, n_unique, nan_dropped)``: arrays of the
    input's length (unique rows descending, then ``(NaN, 0, 0)``),
    ``n_unique`` rows with a nonzero count, and ``nan_dropped`` samples whose
    score was NaN, which callers must report rather than drop silently.
    Counts are int32: exact while the stream's total positives and negatives
    each stay below 2^31."""
    s, delta_tp, delta_fp, keep, nan_dropped = _sorted_deltas(scores, tp_w, fp_w)
    # key non-kept rows NaN so the second sort moves them behind the kept
    # rows; their counts are already zero
    key = torch.where(keep, s, PAD_SCORE)
    s2, (tp_out, fp_out) = sort_descending(key, delta_tp, delta_fp)
    return s2, tp_out, fp_out, keep.sum(dtype=torch.int32), nan_dropped


def compact_counts_fast(
    scores: torch.Tensor, tp_w: torch.Tensor, fp_w: torch.Tensor
):
    """:func:`compact_counts` with the second sort replaced by one stream
    compaction (``ops/stream_compact.py``): the CUDA kernel on the card, its
    plain version on the CPU. Same output, bit for bit."""
    from torcheval_tpu_torch.ops.stream_compact import compact_summary_rows

    s, delta_tp, delta_fp, keep, nan_dropped = _sorted_deltas(scores, tp_w, fp_w)
    s2, tp2, fp2, n_live = compact_summary_rows(s, delta_tp, delta_fp, keep)
    return s2, tp2, fp2, n_live, nan_dropped
