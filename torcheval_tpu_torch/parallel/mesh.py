"""The data-parallel "mesh": ranks of a ``torch.distributed`` world, one
card each, and the helpers that give each rank its block of a batch.

JAX counterpart: ``torcheval_tpu/parallel/mesh.py`` (``data_parallel_mesh``
and ``shard_batch``). There one process drives every device of a
1-D mesh, and a batch is one global array sharded along axis 0. Here each
process drives one card (``cuda:<LOCAL_RANK>``), and the mesh is the
process group: :func:`shard_batch` gives this rank its contiguous block of
a global batch, and the metrics' states merge across ranks when they are
synced (``metrics/toolkit.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from torcheval_tpu_torch.utils import dist as _dist
from torcheval_tpu_torch.utils.convert import as_tensor
from torcheval_tpu_torch.utils.devices import DeviceLike, canonical_device


@dataclass(frozen=True)
class DataParallelMesh:
    """``size`` ranks, of which this process is ``rank``, each evaluating on
    its own device. ``processes`` lists the global ranks of a subgroup, or
    is None for the whole world (the toolkit's ``processes=``)."""

    size: int
    rank: int
    device: torch.device
    processes: Optional[Sequence[int]] = None


def local_device() -> torch.device:
    """``cuda:<LOCAL_RANK>`` (``LOCAL_RANK`` 0 when unset): the card of this
    process among those of its host."""
    return canonical_device(torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))))


def data_parallel_mesh(
    processes: Optional[Sequence[int]] = None, *, device: DeviceLike = None
) -> DataParallelMesh:
    """The whole world (or the ``processes`` subgroup of global ranks) as a
    data-parallel mesh. ``device`` is where this rank's metrics live: its
    card, ``cuda:<LOCAL_RANK>``, unless the caller asks for another (the
    CPU for gloo on a machine without a card). Without an initialised
    world the mesh has one rank."""
    device = local_device() if device is None else canonical_device(device)
    if processes is None:
        return DataParallelMesh(_dist.world_size(), _dist.rank(), device)
    members = _dist.members(processes)
    return DataParallelMesh(len(members), members.index(_dist.rank()), device, members)


def block_bounds(n: int, size: int, rank: int) -> tuple:
    """``[start, stop)`` of rank ``rank``'s contiguous block of ``n`` rows
    split over ``size`` ranks: the first ``n % size`` ranks take one row
    more, so every row lands on exactly one rank."""
    base, extra = divmod(n, size)
    start = rank * base + min(rank, extra)
    return start, start + base + (rank < extra)


def shard_batch(mesh: DataParallelMesh, *arrays: Any):
    """This rank's contiguous block, along axis 0, of each global batch in
    ``arrays`` (tensors, numpy arrays or sequences), as tensors on the
    mesh's device. A batch whose length does not divide by the mesh size
    spreads its remainder over the first ranks, so the blocks cover every
    row exactly once and synced results stay exact; a rank may get an empty
    block. Returns one tensor for one array, else a tuple."""
    out = []
    for a in arrays:
        t = as_tensor(a)
        start, stop = block_bounds(t.shape[0], mesh.size, mesh.rank)
        out.append(t[start:stop].to(mesh.device))
    return out[0] if len(out) == 1 else tuple(out)
