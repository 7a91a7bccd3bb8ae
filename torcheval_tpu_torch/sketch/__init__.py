"""Mergeable bounded-memory sketch state.

JAX counterpart: ``torcheval_tpu/sketch/__init__.py``. The curve and
quantile metrics' O(samples) state becomes, on request, an O(buckets)
resident sketch: fixed-size int32 bucket-count histograms over a
distribution-independent float-prefix partition (``buckets.py``), folded by
the segment-sum kernel (``histogram.py``) and merged by addition, so the
sketch state rides ``merge_state``, the two-round sync and ``state_dict``
unchanged (``cache.py``).

Users: the ``approx=`` mode of ``BinaryAUROC``, ``BinaryAUPRC``,
``MulticlassAUROC``, ``MulticlassAUPRC``, ``BinaryPrecisionRecallCurve``,
``MulticlassPrecisionRecallCurve``, ``HitRate``, ``ReciprocalRank`` and
``Cat``, the ``Quantile`` metric, and ``approx=`` binary curves in a
``SlicedMetricCollection``. Error bounds are computable from the sketch
itself (``auroc_error_bound``, ``auprc_error_bound``, ``relative_error``).
"""

from torcheval_tpu_torch.sketch.buckets import (
    DEFAULT_BUCKET_BITS,
    DEFAULT_MC_BUCKET_BITS,
    MAX_BUCKET_BITS,
    MIN_BUCKET_BITS,
    ascending_key,
    bucket_edges,
    bucket_index,
    bucket_representatives,
    check_bucket_bits,
    relative_error,
)
from torcheval_tpu_torch.sketch.cache import (
    SKETCH_FOLD_ROWS,
    ScoreSketchCacheMixin,
    ValueSketchCacheMixin,
    resolve_approx,
)
from torcheval_tpu_torch.sketch.histogram import (
    auprc_error_bound,
    auprc_from_hist,
    auroc_error_bound,
    auroc_from_hist,
    mc_score_hist_fold,
    mean_from_counts,
    prc_from_hist,
    quantiles_from_counts,
    score_hist_fold,
    value_hist_fold,
)

__all__ = [
    "DEFAULT_BUCKET_BITS",
    "DEFAULT_MC_BUCKET_BITS",
    "MIN_BUCKET_BITS",
    "MAX_BUCKET_BITS",
    "SKETCH_FOLD_ROWS",
    "ScoreSketchCacheMixin",
    "ValueSketchCacheMixin",
    "ascending_key",
    "auprc_error_bound",
    "auprc_from_hist",
    "auroc_error_bound",
    "auroc_from_hist",
    "bucket_edges",
    "bucket_index",
    "bucket_representatives",
    "check_bucket_bits",
    "mc_score_hist_fold",
    "mean_from_counts",
    "prc_from_hist",
    "quantiles_from_counts",
    "relative_error",
    "resolve_approx",
    "score_hist_fold",
    "value_hist_fold",
]
