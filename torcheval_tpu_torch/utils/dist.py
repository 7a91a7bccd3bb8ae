"""The few ``torch.distributed`` primitives the port's collectives use.

JAX counterpart: none. The JAX package's collectives are XLA's
(``multihost_utils.process_allgather``, a ``psum`` inside a program), which
place their buffers themselves. Here each collective's tensors must live
where the process group's backend reads them: the host for gloo (whose
collectives are not counted on to take CUDA tensors), the current CUDA
device for NCCL. :func:`collective_device` says which, and the helpers
below stage a tensor there and bring the result back to the tensor's own
device. Without an initialised process group the world has one rank.
A named mesh axis is a dim of a ``DeviceMesh`` (:func:`mesh_axis`).
Each helper counts its calls and the bytes this rank sends (``.calls``,
``.bytes``: plain attributes, read and zeroed by callers that measure).
:func:`all_to_all_rows` is the ragged exchange behind the distributed
curves (``ops/dist_curves.py``): each rank sends its own number of rows to
each peer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

ProcessGroup = Optional["dist.ProcessGroup"]


def initialized() -> bool:
    """True once this process has joined a ``torch.distributed`` world."""
    return dist.is_available() and dist.is_initialized()


def world_size(group: ProcessGroup = None) -> int:
    """Ranks in ``group`` (the whole world for None); 1 without a world."""
    return dist.get_world_size(group) if initialized() else 1


def rank(group: ProcessGroup = None) -> int:
    """This process's rank in ``group`` (the whole world for None); 0
    without a world."""
    return dist.get_rank(group) if initialized() else 0


def members(processes: Optional[Sequence[int]]) -> Optional[Tuple[int, ...]]:
    """``processes`` (global ranks; None is the whole world) validated and
    sorted. Only members may use a subgroup: a non-member raises here,
    before any collective."""
    if processes is None:
        return None
    group = tuple(sorted({int(p) for p in processes}))
    if not group:
        raise ValueError(
            "processes must be a non-empty collection of process indices or None (the full world)."
        )
    world = world_size()
    for p in group:
        if not 0 <= p < world:
            raise ValueError(f"process index {p} out of range for world size {world}.")
    me = rank()
    if me not in group:
        raise ValueError(
            f"process {me} is not a member of processes={group}; only member processes "
            "may call sync APIs on a subgroup (a non-member entering the collective would "
            "hang the members). Gate the call on membership, as with a torch.distributed "
            "subgroup."
        )
    return group


@dataclass(frozen=True, eq=False)
class MeshAxis:
    """One named dim of a ``DeviceMesh``, resolved for this process: the
    process group its collectives run over, its ``size`` and this
    process's ``rank`` in that group, which orders the dim's tiles and
    every gather over it. Copies share it by reference (it holds process
    groups)."""

    mesh: Any
    name: str
    group: Any
    size: int
    rank: int

    def __deepcopy__(self, memo) -> "MeshAxis":
        return self


def mesh_axis(mesh: Any, name: str) -> MeshAxis:
    """The dim ``name`` of ``mesh`` (a ``DeviceMesh``) for this rank. Raises
    ``ValueError`` for a mesh without dim names or a name it does not have,
    so that a metric or collection built with a wrong name fails when it is
    built, not at its first fold."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if not isinstance(name, str) or name not in names:
        raise ValueError(
            f"mesh axis {name!r} is not a dim of the mesh (dims: {names}); pass a "
            "torch.distributed DeviceMesh with mesh_dim_names and one of its names."
        )
    group = mesh.get_group(name)
    return MeshAxis(mesh, name, group, dist.get_world_size(group), dist.get_rank(group))


def process_group(group: Any) -> ProcessGroup:
    """The process group a collective over ``group`` runs on: a
    :class:`MeshAxis`'s group, or ``group`` itself (a process group, or
    None for the whole world)."""
    return group.group if isinstance(group, MeshAxis) else group


def collective_device(group: ProcessGroup = None) -> torch.device:
    """Where ``group``'s backend reads and writes collective buffers: the
    current CUDA device for NCCL, the host for any other backend."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor, group: ProcessGroup = None) -> torch.Tensor:
    """A new tensor holding the elementwise sum of ``t`` over ``group``, on
    ``t``'s device (staged through the host for gloo)."""
    buf = t.to(collective_device(group), copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    all_reduce_sum.calls += 1
    all_reduce_sum.bytes += buf.numel() * buf.element_size()
    return buf.to(t.device)


all_reduce_sum.calls = 0
all_reduce_sum.bytes = 0


def all_gather_stacked(t: torch.Tensor, group: ProcessGroup = None) -> torch.Tensor:
    """``(world_size(group), *t.shape)``: every rank's ``t`` (the same shape
    and type on every rank) in group-rank order, on the collective device,
    gathered straight into one buffer (NCCL's ``all_gather_into_tensor``;
    for other backends, ``all_gather`` into that buffer's rows)."""
    buf = t.to(collective_device(group)).contiguous()
    out = buf.new_empty((world_size(group),) + tuple(buf.shape))
    if dist.get_backend(group) == "nccl":
        dist.all_gather_into_tensor(out, buf, group=group)
    else:
        dist.all_gather(list(out.unbind(0)), buf, group=group)
    all_gather_stacked.calls += 1
    all_gather_stacked.bytes += buf.numel() * buf.element_size()
    return out


all_gather_stacked.calls = 0
all_gather_stacked.bytes = 0


def all_to_all_rows(
    t: torch.Tensor,
    send_counts: List[int],
    recv_counts: List[int],
    group: ProcessGroup = None,
) -> torch.Tensor:
    """One ragged all-to-all over ``group``: ``t``'s rows (axis 0) are laid
    out by destination, ``send_counts[k]`` of them for group rank ``k``, and
    the result holds ``recv_counts[k]`` rows from each rank ``k`` in group
    order, on ``t``'s device (staged through the host for gloo). Every rank
    passes the counts its peers pass for it: ``recv_counts[k]`` here is
    ``send_counts[me]`` on rank ``k``."""
    dev = collective_device(group)
    buf = t.to(dev).contiguous()
    out = buf.new_empty((sum(recv_counts),) + tuple(buf.shape[1:]))
    dist.all_to_all_single(
        out, buf, output_split_sizes=list(recv_counts), input_split_sizes=list(send_counts),
        group=group,
    )
    all_to_all_rows.calls += 1
    all_to_all_rows.bytes += buf.numel() * buf.element_size()
    return out.to(t.device)


all_to_all_rows.calls = 0
all_to_all_rows.bytes = 0
