"""Recall@k metric.

JAX counterpart: ``torcheval_tpu/metrics/ranking/recall.py``; the per-sample
math is in ``functional/ranking/retrieval.py`` and the shared state in
``ranking/_retrieval.py``.
"""

from __future__ import annotations

from torcheval_tpu_torch.metrics.functional.ranking.retrieval import _recall_kernel
from torcheval_tpu_torch.metrics.ranking._retrieval import RetrievalMeanMetric


class RecallAtK(RetrievalMeanMetric):
    """Mean Recall@k: ``|top-k & relevant| / |relevant|`` per row; rows
    with no relevant label are left out. Arguments and state as :class:`NDCG`.
    """

    _kernel = staticmethod(_recall_kernel)
