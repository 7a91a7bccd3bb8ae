"""Mergeable bounded-memory histogram sketches over float-prefix buckets.

JAX counterpart: ``torcheval_tpu/sketch/histogram.py``. Two sketch shapes,
both plain int32 count tensors plus an int32 NaN count, so they ride
``merge_state``, the two-round sync (SUM lanes: adding buckets is the exact
merge) and ``state_dict`` with no new machinery:

* **score sketch**: per-bucket ``(tp, fp)`` counts for the curve metrics,
  ``(B,)`` binary or ``(C, B)`` one-vs-all. The compute feeds the counts to
  the presorted counts functions (``ops/curves.py``) with the bucket
  representatives as thresholds: samples in one bucket become one tie
  group, which is the whole approximation; the order across buckets is
  exact.
* **value sketch**: per-bucket counts of a value multiset (``Quantile``,
  and the ``approx=`` modes of ``HitRate``, ``ReciprocalRank`` and
  ``Cat``).

**Every fold is one launch of the segment-sum kernel** (``ops/scatter.py``,
``csrc/scatter.cu`` on the card, its plain version on the CPU): the binary
fold sums ``(N, 2)`` int32 lanes ``[t, 1 - t]`` by bucket into ``2^bits``
segments (the JAX package's two segment sums in one launch; on the card
the kernel makes the buckets, lanes and NaN mask itself from the scores
and targets, ``score_segment_sum``, and no key or lane tensor exists); the
multiclass fold sums the same two lanes over the ``(C, N)`` columns by the
combined key ``c * B + bucket`` into ``C * B`` segments; the value fold sums
int32 ones. NaN samples go to row -1, which the kernel drops, and are
counted apart. There is one route for any bucket or class count: the
histogram kernel (``csrc/hist.cu``) tiles its bins through shared memory
and would read the stream once a tile, where the segment sum does work in
proportion to the stream for any segment count.

Error bounds, computed a posteriori from the sketch itself (float64 numpy
on the host): AUROC moves by at most ``0.5 * sum_b tp_b * fp_b / (P * N)``
(:func:`auroc_error_bound`: only pairs that share a bucket change, each by
at most half a concordance); average precision by the envelope sum of
:func:`auprc_error_bound`; a quantile or a mean by
``buckets.relative_error(bits)`` relative to the exact order statistic.

**Subnormal products.** :func:`mean_from_counts` multiplies counts by the
representatives in float32; XLA on the CPU flushes a subnormal product to
zero and PyTorch does not, so a sketch whose mass lies in the buckets next
to zero can give a mean of about 1e-40 here where the JAX package gives
0.0, an absolute difference far below 1e-8. Nothing here adds a flush.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from torcheval_tpu_torch import _build
from torcheval_tpu_torch.ops.curves import (
    binary_auprc_counts_presorted_kernel,
    binary_auroc_counts_presorted_kernel,
)
from torcheval_tpu_torch.ops.scatter import score_segment_sum, segment_sum
from torcheval_tpu_torch.sketch.buckets import (
    bucket_index,
    check_bucket_bits,
    representatives_on,
)

__all__ = [
    "score_hist_fold",
    "score_hist_fold_plain",
    "mc_score_hist_fold",
    "value_hist_fold",
    "auroc_from_hist",
    "auprc_from_hist",
    "prc_points_from_hist",
    "trim_hist_curve",
    "prc_from_hist",
    "mean_from_counts",
    "quantiles_from_counts",
    "counts_exactness_flag",
    "auroc_error_bound",
    "auprc_error_bound",
]


def _nan_count(nan: torch.Tensor) -> torch.Tensor:
    return nan.sum(dtype=torch.int32)


# ------------------------------------------------------------------ folds
def _combined_key(key: torch.Tensor, width: int, rows: int) -> torch.Tensor:
    """``row * width + key`` over ``(rows, N)`` keys (-1 kept for dropped
    entries), int32 while the extent fits it."""
    offset = torch.arange(rows, dtype=torch.int64, device=key.device)[:, None] * width
    combined = torch.where(key >= 0, key.to(torch.int64) + offset, -1)
    return combined.to(torch.int32) if rows * width < 2**31 else combined


def _value_counts(rows: torch.Tensor, bucket_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(R, B)`` bucket counts and ``(R,)`` NaN counts of ``(R, M)`` value
    rows: one segment sum of int32 ones by ``r * B + bucket``."""
    num = 1 << bucket_bits
    nan = torch.isnan(rows.to(torch.float32))
    key = torch.where(nan, -1, bucket_index(rows, bucket_bits))
    idx = _combined_key(key, num, rows.shape[0]).reshape(-1)
    ones = torch.ones(idx.shape[0], dtype=torch.int32, device=rows.device)
    counts = segment_sum(ones, idx, rows.shape[0] * num).reshape(rows.shape[0], num)
    return counts, nan.sum(dim=1, dtype=torch.int32)


class _ValueCounts(torch.autograd.Function):
    """The value fold as a function with a ``torch.func.vmap`` rule (no
    gradient: counts are integers). Under ``vmap`` a batch of B value
    tensors is one segment sum over ``B * 2^bits`` segments, and the bucket
    ids are computed on the unbatched tensor: ``Tensor.view(dtype)``, the
    bitcast behind them, has no batching rule in every PyTorch release, and
    the kernel wrapper must never see a batched tensor
    (``ops/confusion.py::_ClassCounts`` is the same rule for class
    counts)."""

    @staticmethod
    def forward(values: torch.Tensor, bucket_bits: int):
        counts, nan = _value_counts(values.reshape(1, -1), bucket_bits)
        return counts[0], nan[0]

    @staticmethod
    def setup_context(ctx, inputs, output) -> None:
        pass

    @staticmethod
    def vmap(info, in_dims, values: torch.Tensor, bucket_bits: int):
        if in_dims[0] is None:
            return _ValueCounts.forward(values, bucket_bits), (None, None)
        values = values.movedim(in_dims[0], 0)
        return _value_counts(values.reshape(values.shape[0], -1), bucket_bits), (0, 0)


def score_hist_fold(
    scores: torch.Tensor, targets: torch.Tensor, bucket_bits: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold ``(N,)`` binary scores and targets into ``(B,)`` int32 per-bucket
    ``(tp, fp)`` counts and the batch's NaN-sample count. Targets are cast
    to int32 as the JAX package casts them (``tp += t``, ``fp += 1 - t``).
    Integer adds, so any chunking of a stream gives the same counts.

    A CPU tensor runs :func:`score_hist_fold_plain`; on the card the whole
    fold is one launch of the segment-sum kernel
    (``ops/scatter.py::score_segment_sum``), which makes the bucket ids,
    lanes and NaN mask in registers and gives the same counts bit for bit."""
    bits = check_bucket_bits(bucket_bits)
    if _build.runs_plain(scores):
        return score_hist_fold_plain(scores, targets, bits)
    hist, nan = score_segment_sum(scores, targets, bits)
    return hist[:, 0].contiguous(), hist[:, 1].contiguous(), nan


def score_hist_fold_plain(
    scores: torch.Tensor, targets: torch.Tensor, bucket_bits: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`score_hist_fold` in tensor ops: the bucket ids
    (:func:`bucket_index`), the NaN mask and the stacked ``[t, 1 - t]``
    lanes, summed by one :func:`segment_sum` (its plain version on the CPU,
    the kernel on the card, where this is the fused fold's reference)."""
    num = 1 << check_bucket_bits(bucket_bits)
    nan = torch.isnan(scores.to(torch.float32))
    t = targets.to(torch.int32)
    lanes = torch.stack([t, 1 - t], dim=-1)
    idx = torch.where(nan, -1, bucket_index(scores, bucket_bits))
    hist = segment_sum(lanes, idx, num)
    return hist[:, 0].contiguous(), hist[:, 1].contiguous(), _nan_count(nan)


def mc_score_hist_fold(
    scores: torch.Tensor, labels: torch.Tensor, bucket_bits: int, num_classes: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-vs-all fold of ``(N, C)`` scores and ``(N,)`` integer labels into
    ``(C, B)`` per-class ``(tp, fp)`` counts and the NaN per-class score
    entry count (a row with NaN scores adds one a NaN class). One segment
    sum over the ``C * N`` entries by ``c * B + bucket``."""
    num = 1 << check_bucket_bits(bucket_bits)
    cols = scores.T  # (C, N)
    classes = torch.arange(num_classes, dtype=torch.int32, device=scores.device)
    onehot = (labels.to(torch.int32)[None, :] == classes[:, None]).to(torch.int32)
    nan = torch.isnan(cols.to(torch.float32))
    key = torch.where(nan, -1, bucket_index(cols, bucket_bits))
    idx = _combined_key(key, num, num_classes).reshape(-1)
    lanes = torch.stack([onehot, 1 - onehot], dim=-1).reshape(-1, 2)
    hist = segment_sum(lanes, idx, num_classes * num).reshape(num_classes, num, 2)
    return hist[..., 0].contiguous(), hist[..., 1].contiguous(), _nan_count(nan)


def value_hist_fold(
    values: torch.Tensor, bucket_bits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold values of any shape (flattened) into ``(B,)`` int32 bucket
    counts and the NaN count: one segment-sum launch of int32 ones, under
    ``torch.func.vmap`` too (one launch for the whole batch)."""
    return _ValueCounts.apply(values, check_bucket_bits(bucket_bits))


# --------------------------------------------------------------- computes
def _desc_reps(bucket_bits: int, device) -> torch.Tensor:
    """Representatives in descending-threshold order (reversed bucket ids),
    the presorted counts functions' row order."""
    return representatives_on(bucket_bits, device, descending=True)


def auroc_from_hist(tp: torch.Tensor, fp: torch.Tensor, bucket_bits: int) -> torch.Tensor:
    """AUROC of a ``(..., B)`` score sketch along the last axis: reversed,
    the buckets are unique descending thresholds, so the sort-free
    presorted function applies (empty buckets add zero-width segments)."""
    return binary_auroc_counts_presorted_kernel(
        _desc_reps(bucket_bits, tp.device), tp.flip(-1), fp.flip(-1)
    )


def auprc_from_hist(tp: torch.Tensor, fp: torch.Tensor, bucket_bits: int) -> torch.Tensor:
    """Average precision of a ``(..., B)`` score sketch (see
    :func:`auroc_from_hist`)."""
    return binary_auprc_counts_presorted_kernel(
        _desc_reps(bucket_bits, tp.device), tp.flip(-1), fp.flip(-1)
    )


def prc_points_from_hist(
    tp: torch.Tensor, fp: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-length ``(precision, recall, nonempty)`` rows in descending
    threshold order from a ``(..., B)`` score sketch, along the last axis;
    :func:`trim_hist_curve` keeps the nonempty buckets."""
    ctp = torch.cumsum(tp.flip(-1).to(torch.int32), -1, dtype=torch.int32)
    cfp = torch.cumsum(fp.flip(-1).to(torch.int32), -1, dtype=torch.int32)
    tpf = ctp.to(torch.float32)
    fpf = cfp.to(torch.float32)
    precision = tpf / torch.clamp(tpf + fpf, min=1.0)
    total_pos = tpf[..., -1:]
    recall = torch.where(total_pos > 0, tpf / torch.clamp(total_pos, min=1.0), 1.0)
    nonempty = (tp + fp).flip(-1) > 0
    return precision, recall, nonempty


def trim_hist_curve(
    precision: torch.Tensor, recall: torch.Tensor, nonempty: torch.Tensor, bucket_bits: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ``(B,)`` row of :func:`prc_points_from_hist` in the reference
    curve layout: nonempty buckets only, ascending thresholds (the
    representatives), the ``(precision=1, recall=0)`` origin appended. One
    host read (the mask's count), as the exact curve's trim."""
    keep = nonempty
    reps = _desc_reps(bucket_bits, precision.device)
    p = precision[keep].flip(0)
    r = recall[keep].flip(0)
    t = reps[keep].flip(0)
    p = torch.cat([p, p.new_ones(1)])
    r = torch.cat([r, r.new_zeros(1)])
    return p, r, t


def prc_from_hist(
    tp: torch.Tensor, fp: torch.Tensor, bucket_bits: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference-layout ``(precision, recall, thresholds)`` of a ``(B,)``
    score sketch: one point per nonempty bucket, ascending thresholds, the
    origin appended."""
    precision, recall, nonempty = prc_points_from_hist(tp, fp)
    return trim_hist_curve(precision, recall, nonempty, bucket_bits)


def mean_from_counts(counts: torch.Tensor, bucket_bits: int) -> torch.Tensor:
    """Representative-weighted mean of a value sketch, within
    ``relative_error(bucket_bits)`` of the exact mean; 0.0 for an empty
    sketch. See the module note on subnormal products."""
    reps = representatives_on(bucket_bits, counts.device)
    c = counts.to(torch.float32)
    # empty NaN-region buckets must not poison the sum (0 * NaN)
    weighted = torch.where(counts > 0, c * reps, 0.0)
    n = torch.sum(c)
    return torch.where(n > 0, torch.sum(weighted) / torch.clamp(n, min=1.0), 0.0)


def quantiles_from_counts(
    counts: torch.Tensor, q: Tuple[float, ...], bucket_bits: int
) -> torch.Tensor:
    """For each ``q``, the representative of the bucket holding the order
    statistic of (1-indexed) rank ``ceil(q * n)`` (the ``inverted_cdf``
    convention), within ``relative_error(bucket_bits)`` of it. Ranks are
    float32 arithmetic, as in the JAX package. NaN for an empty sketch."""
    reps = representatives_on(bucket_bits, counts.device)
    cum = torch.cumsum(counts.to(torch.int32), 0, dtype=torch.int32)
    n = cum[-1]
    qs = torch.tensor(q, dtype=torch.float32, device=counts.device)
    rank = torch.ceil(qs * n.to(torch.float32)).to(torch.int32)
    rank = torch.minimum(torch.clamp(rank, min=1), n)
    idx = torch.searchsorted(cum, rank, side="left")
    vals = reps[torch.clamp(idx, 0, reps.shape[0] - 1)]
    return torch.where(n > 0, vals, float("nan"))


def counts_exactness_flag(*arrays: torch.Tensor) -> torch.Tensor:
    """True (a bool tensor) when int32 count state can no longer be trusted:
    a bucket went negative (a wrapped add), or a bucket-axis cumulative sum
    (one per count row: per class for ``(C, B)`` state) would reach
    ``2^31 (1 - 2^-7)``. Totals are summed in float32 against that slightly
    conservative edge."""
    neg = None
    worst = None
    for c in arrays:
        n = torch.min(c) < 0
        w = torch.max(torch.sum(c.to(torch.float32), dim=-1))
        neg = n if neg is None else neg | n
        worst = w if worst is None else torch.maximum(worst, w)
    return neg | (worst >= 2.0**31 * (1.0 - 2.0**-7))


# ----------------------------------------------------------- error bounds
def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def auroc_error_bound(tp, fp) -> float:
    """Bound on ``|approx AUROC - exact AUROC|`` for the stream a ``(B,)``
    sketch summarises: every positive-negative pair that shares a bucket
    moves by at most half a concordance. Float64 on the host."""
    tp, fp = _host64(tp), _host64(fp)
    pos, neg = tp.sum(), fp.sum()
    if pos == 0 or neg == 0:
        return 0.0
    return float(0.5 * np.sum(tp * fp) / (pos * neg))


def auprc_error_bound(tp, fp) -> float:
    """Bound on ``|approx AP - exact AP|``: in a bucket of ``t`` positives
    and ``f`` negatives after cumulative ``(T0, F0)``, every positive's
    precision under any order inside the bucket (and under the tie-group
    formula) lies in ``[(T0+1)/(T0+1+F0+f), (T0+t)/(T0+t+F0)]``; the bound
    sums those widths weighted ``t / P``. Float64 on the host."""
    tp, fp = _host64(tp)[::-1], _host64(fp)[::-1]
    pos = tp.sum()
    if pos == 0:
        return 0.0
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    t0 = ctp - tp
    f0 = cfp - fp
    hi = (t0 + tp) / np.maximum(t0 + tp + f0, 1.0)
    lo = (t0 + 1.0) / (t0 + 1.0 + f0 + fp)
    width = np.where(tp > 0, hi - lo, 0.0)
    return float(np.sum(tp * width) / pos)
