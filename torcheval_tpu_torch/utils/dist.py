"""The few ``torch.distributed`` primitives the port's collectives use.

JAX counterpart: none. The JAX package's collectives are XLA's
(``multihost_utils.process_allgather``, a ``psum`` inside a program), which
place their buffers themselves. Here each collective's tensors must live
where the process group's backend reads them: the host for gloo (whose
collectives are not counted on to take CUDA tensors), the current CUDA
device for NCCL. :func:`collective_device` says which, and the helpers
below stage a tensor there and bring the result back to the tensor's own
device. Without an initialised process group the world has one rank.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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
    return buf.to(t.device)


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
    return out
