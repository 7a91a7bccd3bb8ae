"""torcheval_tpu_torch: the PyTorch and CUDA port of torcheval_tpu.

JAX counterpart: ``torcheval_tpu/__init__.py``. Streaming metrics whose
state is a set of ``torch.Tensor``s on one NVIDIA GPU (Hopper), with the
JAX package's hand-written TPU kernels replaced by hand-written CUDA kernels
(``csrc/``). Metrics run on ``cuda`` unless the caller passes
``device="cpu"``. Ported so far (``torcheval_tpu_torch.metrics`` and
``.metrics.functional``): ``MulticlassAccuracy``, ``BinaryAccuracy``,
``MultilabelAccuracy``, ``TopKMultilabelAccuracy``, ``BinaryAUROC``,
``BinaryAUPRC``, ``HitRate``, ``ReciprocalRank``, ``NDCG``, ``MAP``,
``RecallAtK``, ``Sum``, ``Mean``, ``Max``, ``Min``, ``MeanSquaredError``,
``MulticlassF1Score``, ``BinaryF1Score``, ``MetricCollection`` and
``SlicedMetricCollection``, on the histogram, stream-compaction, top-k and
segment-sum kernels; cross-process sync on ``torch.distributed``
(``metrics.toolkit``) and data-parallel evaluation (``parallel``); and the
rest of the JAX package since, down to the tools (``tools``: module
summaries and per-module FLOPs for ``nn.Module``) and the examples.
"""

from torcheval_tpu_torch.version import __version__

__all__ = ["__version__"]
