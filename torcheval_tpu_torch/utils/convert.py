"""Tensor conversion.

JAX counterpart: ``torcheval_tpu/utils/convert.py`` (``as_jax``,
``to_numpy``). Every
public entry point funnels its inputs through :func:`as_tensor`, so callers
may pass tensors, numpy arrays or Python sequences.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def as_tensor(
    x: Any, device: Optional[torch.device] = None, dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """``x`` as a ``torch.Tensor`` on ``device`` (where it already is, for a
    tensor, when ``device`` is None; the CPU for anything else).

    A tensor already on ``device`` is returned as it is, not copied. A numpy
    array is copied, so the result never aliases a buffer the caller may
    reuse (and a read-only array needs no special case)."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def to_numpy(x: Any) -> np.ndarray:
    """Device -> host transfer: a tensor's values as a numpy array (detached,
    copied off the card), anything else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
