"""The no-JAX guard.

The benchmark measures the PyTorch and CUDA port only. A run fails when
any module it loaded has the top-level name (the part before the first
dot, compared whole) of JAX, its libraries or the JAX package: the port's
own name, ``torcheval_tpu_torch``, begins with the JAX package's and is
not a match.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "torcheval_tpu"})


def forbidden_modules(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: every
    module this process has loaded), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in list(names)} & FORBIDDEN)
