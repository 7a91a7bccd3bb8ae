"""Class histogram: the CUDA kernel ``csrc/hist.cu`` and its plain version.

JAX counterpart: ``torcheval_tpu/ops/pallas_hist.py`` (``pallas_class_counts``,
the Pallas kernel ``_hist_kernel``). Both compute the unweighted
``bincount(labels, minlength=num_classes)`` with labels outside
``[0, num_classes)`` dropped, as int32.

:func:`hist` runs the kernel on a CUDA tensor and raises if it cannot;
:func:`hist_plain` is the same function in plain PyTorch, which :func:`hist`
runs for a CPU tensor and which tests and ``chip_smoke.py`` hold the kernel
against. :func:`hist` is watched by the recompile watchdog
(``obs/recompile.py``) under the entry ``hist``; each launch counts one
``jit.calls{entry=hist}`` while obs is enabled, and its byte model
(:func:`_hist_cost`) feeds the entry's cost gauges. :func:`sharded_class_counts` is the counterpart of
``sharded_pallas_class_counts`` (``pallas_hist.py:160-165``): each rank
counts its own labels with :func:`hist`, and one int32 ``all_reduce`` sums
the counts over the process group.
"""

from __future__ import annotations

import torch

from torcheval_tpu_torch import _build
from torcheval_tpu_torch.obs.cost import nbytes
from torcheval_tpu_torch.obs.recompile import count_launch, watched
from torcheval_tpu_torch.utils import dist as _dist

_LABEL_DTYPES = (torch.int32, torch.int64)


def _check(labels: torch.Tensor, num_classes: int) -> None:
    if labels.ndim != 1:
        raise ValueError(f"labels must be 1-D, got shape {tuple(labels.shape)}.")
    if labels.dtype not in _LABEL_DTYPES:
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}.")
    if num_classes < 0:
        raise ValueError(f"num_classes must be >= 0, got {num_classes}.")


def hist_plain(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Plain PyTorch histogram: ``index_add_`` into ``num_classes + 1`` bins,
    where the extra bin takes every out-of-range label and is cut off."""
    _check(labels, num_classes)
    valid = (labels >= 0) & (labels < num_classes)
    idx = torch.where(valid, labels, num_classes)
    out = torch.zeros(num_classes + 1, dtype=torch.int32, device=labels.device)
    out.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return out[:num_classes]


def _hist_cost(args, kwargs, out):
    """The labels read once and the counts written once; no float adds."""
    moved = nbytes(args[0], out)
    return 0, moved, moved


@watched(name="hist", cost=_hist_cost, counts_launches=True)
def hist(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``(num_classes,)`` int32 counts of ``labels`` (int32 or int64, 1-D).

    A CPU tensor runs :func:`hist_plain`. A CUDA tensor launches the kernel
    on PyTorch's current stream, without synchronising, and counts the
    launch (``jit.calls{entry=hist}``)."""
    _check(labels, num_classes)
    if _build.runs_plain(labels):
        return hist_plain(labels, num_classes)
    lib = _build.library()
    labels = labels.contiguous()
    _build.require_cuda("hist", labels)
    out = torch.zeros(num_classes, dtype=torch.int32, device=labels.device)
    if labels.numel() == 0 or num_classes == 0:
        return out
    fn = lib.tc_hist_i32 if labels.dtype == torch.int32 else lib.tc_hist_i64
    with torch.cuda.device(labels.device):
        err = fn(
            labels.data_ptr(),
            labels.numel(),
            num_classes,
            out.data_ptr(),
            _build.stream_of(labels),
        )
    _build.check(err, "hist")
    count_launch("hist")
    return out


def sharded_class_counts(labels: torch.Tensor, num_classes: int, group=None) -> torch.Tensor:
    """``(num_classes,)`` int32 counts of every rank's ``labels`` in
    ``group`` (the whole ``torch.distributed`` world for None): :func:`hist`
    on this rank's labels, then one int32 ``all_reduce(SUM)``, staged
    through the host for gloo. The result is on ``labels``' device on every
    rank. With one rank it equals :func:`hist`; with no world it is
    :func:`hist`, and no collective runs."""
    local = hist(labels, num_classes)
    if not _dist.initialized():
        return local
    return _dist.all_reduce_sum(local, group)
