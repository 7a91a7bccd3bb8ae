"""NDCG@k metric.

JAX counterpart: ``torcheval_tpu/metrics/ranking/ndcg.py``; the per-sample
math is in ``functional/ranking/retrieval.py`` and the shared state in
``ranking/_retrieval.py``.
"""

from __future__ import annotations

from torcheval_tpu_torch.metrics.functional.ranking.retrieval import _ndcg_kernel
from torcheval_tpu_torch.metrics.ranking._retrieval import RetrievalMeanMetric


class NDCG(RetrievalMeanMetric):
    """Mean NDCG@k: linear graded gains, ``1 / log2(rank + 2)``
    discounts, normalised per row by its ideal DCG; rows whose ideal DCG
    is zero are left out.

    Args:
        k: cutoff; ``None`` ranks every label.
        topk_method: the lowering of ``ops/topk.py`` for both the score
            ranking and, for NDCG, the ideal ranking; checked at
            construction.

    State: ``score_sum`` (float32) and ``num_valid`` (int32), both SUM.
    """

    _kernel = staticmethod(_ndcg_kernel)
