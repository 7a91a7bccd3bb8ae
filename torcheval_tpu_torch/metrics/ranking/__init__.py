"""Ranking and retrieval metric classes. JAX counterpart:
``torcheval_tpu/metrics/ranking/__init__.py``."""

from torcheval_tpu_torch.metrics.ranking.hit_rate import HitRate
from torcheval_tpu_torch.metrics.ranking.map import MAP
from torcheval_tpu_torch.metrics.ranking.ndcg import NDCG
from torcheval_tpu_torch.metrics.ranking.recall import RecallAtK
from torcheval_tpu_torch.metrics.ranking.reciprocal_rank import ReciprocalRank

__all__ = ["HitRate", "MAP", "NDCG", "RecallAtK", "ReciprocalRank"]
