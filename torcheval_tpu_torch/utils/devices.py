"""Device helpers.

JAX counterpart: ``torcheval_tpu/utils/devices.py``. There ``None`` means
JAX's default device. Here ``None`` means the first CUDA device, and the
CPU is used only when the caller asks for it: with no GPU, ``None`` and
``"cuda"`` raise instead of falling back to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def canonical_device(device: DeviceLike) -> torch.device:
    """Resolve a device spec to a concrete ``torch.device``.

    ``None`` is ``cuda:0``; ``"cuda"`` is the current CUDA device; ``"cpu"``
    and any explicit ``torch.device`` are taken as given. Raises when a CUDA
    device is asked for (or defaulted to) and none is available."""
    if device is None:
        device = torch.device("cuda", 0)
    elif isinstance(device, str):
        device = torch.device(device)
    elif not isinstance(device, torch.device):
        raise TypeError(
            f"device must be a torch.device, str or None, got {type(device)!r}."
        )
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "No CUDA device is available. Metrics run on the GPU by "
                "default; pass device='cpu' to run on the CPU."
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
