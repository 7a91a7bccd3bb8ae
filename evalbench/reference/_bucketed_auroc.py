"""The AUROC of a float-prefix bucket sketch, written out from its
definition (a helper, like ``_common.py``: no metric class is named so,
and the harness does not load it).

The sketch: each float32 score maps to a 32-bit order key, whose unsigned
order is the float order: a score with the sign bit set takes its bits
inverted, any other its bits with the sign bit set. ``-0.0`` and every
subnormal count as ``+0.0``, and NaN takes the top key. A score's bucket
is the top ``bits`` bits of its key. Each bucket counts its positives and
negatives, and the AUROC treats the rows of one bucket as one tie: a
positive beats every negative of a lower bucket and half of each negative
of its own, over all positive-negative pairs. Counts are exact integers;
the sums and the division are float64.
"""

import torch

TINY = torch.finfo(torch.float32).tiny


def bucket_of(scores: torch.Tensor, bits: int) -> torch.Tensor:
    """The bucket of each float32 score, int64 in ``[0, 2**bits)``."""
    x = scores.to(torch.float32)
    x = torch.where(x.abs() < TINY, torch.zeros_like(x), x)
    raw = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    negative = raw >= 0x80000000
    key = torch.where(negative, 0xFFFFFFFF - raw, raw + 0x80000000)
    key = torch.where(torch.isnan(x), torch.full_like(key, 0xFFFFFFFF), key)
    return key >> (32 - bits)


def bucket_counts(scores: torch.Tensor, target: torch.Tensor, bits: int):
    """``(positives, negatives)`` a bucket, int64 ``(2**bits,)`` each."""
    b = bucket_of(scores, bits)
    pos = (target != 0).to(torch.int64)
    n = 1 << bits
    tp = torch.zeros(n, dtype=torch.int64, device=b.device).index_add_(0, b, pos)
    fp = torch.zeros(n, dtype=torch.int64, device=b.device).index_add_(0, b, 1 - pos)
    return tp, fp


def auroc_from_counts(tp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """The tie-at-one-half AUROC over buckets in ascending order, float64."""
    below = torch.cumsum(fp, 0) - fp  # negatives in lower buckets
    wins2 = (tp * (2 * below + fp)).sum()  # twice the concordant pairs
    pairs = tp.sum().to(torch.float64) * fp.sum().to(torch.float64)
    return wins2.to(torch.float64) / 2 / pairs


def bucketed_auroc(scores: torch.Tensor, target: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """The sketch's AUROC of ``(N,)`` scores and binary targets."""
    return auroc_from_counts(*bucket_counts(scores, target, bits))
