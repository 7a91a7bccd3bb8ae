"""MAP@k metric.

JAX counterpart: ``torcheval_tpu/metrics/ranking/map.py``; the per-sample
math is in ``functional/ranking/retrieval.py`` and the shared state in
``ranking/_retrieval.py``.
"""

from __future__ import annotations

from torcheval_tpu_torch.metrics.functional.ranking.retrieval import _map_kernel
from torcheval_tpu_torch.metrics.ranking._retrieval import RetrievalMeanMetric


class MAP(RetrievalMeanMetric):
    """Mean MAP@k: ``(1 / min(m, k)) * sum_j rel_j * precision@j`` per
    row, with ``m`` the row's relevant count; rows with no relevant
    label are left out. Arguments and state as :class:`NDCG`.
    """

    _kernel = staticmethod(_map_kernel)
