"""torcheval_tpu_torch: the PyTorch and CUDA port of torcheval_tpu.

JAX counterpart: ``torcheval_tpu/__init__.py``. Streaming metrics whose
state is a set of ``torch.Tensor``s on one NVIDIA GPU (Hopper), with the
JAX package's hand-written TPU kernels replaced by hand-written CUDA kernels
(``csrc/``). Metrics run on ``cuda`` unless the caller passes
``device="cpu"``. Ported so far (``torcheval_tpu_torch.metrics`` and
``.metrics.functional``): ``MulticlassAccuracy``, ``BinaryAccuracy``,
``MultilabelAccuracy``, ``TopKMultilabelAccuracy``, ``BinaryAUROC``,
``BinaryAUPRC``, ``HitRate``, ``ReciprocalRank``, ``NDCG``, ``MAP`` and
``RecallAtK``, on the histogram, stream-compaction and top-k kernels.
"""

from torcheval_tpu_torch.version import __version__

__all__ = ["__version__"]
