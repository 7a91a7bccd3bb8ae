"""torcheval_tpu_torch: the PyTorch and CUDA port of torcheval_tpu.

JAX counterpart: ``torcheval_tpu/__init__.py``. Streaming metrics whose
state is a set of ``torch.Tensor``s on one NVIDIA GPU (Hopper), with the
JAX package's hand-written TPU kernels replaced by hand-written CUDA kernels
(``csrc/``). Metrics run on ``cuda`` unless the caller passes
``device="cpu"``. This slice ports ``MulticlassAccuracy``,
``BinaryAccuracy``, ``BinaryAUROC`` and ``BinaryAUPRC``
(``torcheval_tpu_torch.metrics``).
"""

from torcheval_tpu_torch.version import __version__

__all__ = ["__version__"]
