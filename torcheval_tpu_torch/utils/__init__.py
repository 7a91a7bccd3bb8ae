"""Conversion and device helpers. JAX counterpart: ``torcheval_tpu/utils/``."""

from torcheval_tpu_torch.utils.convert import as_tensor
from torcheval_tpu_torch.utils.devices import canonical_device

__all__ = ["as_tensor", "canonical_device"]
