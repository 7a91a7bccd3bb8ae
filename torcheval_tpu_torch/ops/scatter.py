"""Segment scatter: per-sample deltas reduced into a leading segment axis.

JAX counterpart: ``torcheval_tpu/ops/scatter.py`` (``segment_scatter``
without its ``mesh``/``axis`` route, ``_resolve_method``, ``_apply_local``,
and ``pallas_segment_sum`` with its Pallas kernel ``_scatter_kernel``). The
sliced collection (``metrics/sliced.py``) folds every batch through
:func:`segment_scatter`: ``out[r] = reduce(vals[i] for rows[i] == r)`` for
``r`` in ``[0, num_segments)``; rows outside that range (negative or
``>= num_segments``) are dropped.

* :func:`segment_sum` is the kernel's wrapper, the counterpart of
  ``pallas_segment_sum``: a CUDA tensor launches ``csrc/scatter.cu`` and
  adds one to ``segment_sum.launches``; a CPU tensor runs
  :func:`segment_sum_plain` (``index_add_`` into a dead extra segment that
  is cut off), which the tests and ``chip_smoke.py`` also hold the kernel
  against. Values are int32, int64, float32 or float64 and keep their type;
  other types raise ``TypeError``. The TPU kernel sums a float32 one-hot
  product, exact for integers to 2^24 a segment and only inside a segment
  envelope; the CUDA kernel adds with atomics of the values' own type, so
  integer sums are exact (and wrap like XLA's scatter-add, the JAX
  package's reference route) for any segment count, and ``auto`` sends every
  sum on a CUDA tensor to it.
* Float sums, in the kernel and in the plain version alike, add in an order
  that is not the reference's (atomics on the card run in no fixed order),
  so they are not bitwise reproducible. The bound every route meets, for
  any order of adds, is ``|got - exact| <= (count - 1) * u * sum(|v|)`` per
  segment and lane, with ``count`` the segment's number of samples and
  ``u`` = 2^-24 for float32, 2^-53 for float64 (the bound of recursive
  summation); NaN and infinities propagate as in any sum.
* ``reduce="max"``/``"min"`` run ``scatter_reduce_`` (``amax``/``amin``)
  into a buffer filled with the reduce's identity (-inf or the integer
  minimum for max, +inf or the maximum for min), as the JAX package leaves
  them to XLA's ``segment_max``/``segment_min`` outside any Pallas kernel.
  NaN propagates to its segment, as in ``jax.ops.segment_max``.

Methods: ``"auto"`` and ``"kernel"`` (the JAX package's ``"pallas"``) run
:func:`segment_sum`, which launches the kernel on a CUDA tensor and runs the
plain version on a CPU one; ``"torch"`` runs the plain version on any
device, an explicit choice that nothing on the sliced path makes. The
sharded route (``mesh=``/``axis=``) comes with the distributed slice.
"""

from __future__ import annotations

import math

import torch

from torcheval_tpu_torch import _build

_METHODS = ("auto", "kernel", "torch")
_REDUCES = ("sum", "max", "min")
# the kernel's type codes (csrc/scatter.cu, tc_segment_sum)
_VAL_CODES = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3}
_ROW_CODES = {torch.int32: 0, torch.int64: 1}
_SCATTER_REDUCE = {"max": "amax", "min": "amin"}


def _check(vals: torch.Tensor, rows: torch.Tensor, num_segments: int) -> None:
    if vals.ndim < 1 or rows.ndim != 1 or vals.shape[0] != rows.shape[0]:
        raise ValueError(
            "segment scatter wants vals (N, ...) with rows (N,), got "
            f"{tuple(vals.shape)} / {tuple(rows.shape)}."
        )
    if rows.dtype not in _ROW_CODES:
        raise TypeError(f"rows must be int32 or int64, got {rows.dtype}.")
    if num_segments < 0:
        raise ValueError(f"num_segments must be >= 0, got {num_segments}.")


def _check_sum_dtype(vals: torch.Tensor) -> None:
    if vals.dtype not in _VAL_CODES:
        raise TypeError(
            f"segment_sum takes int32, int64, float32 or float64 values, got {vals.dtype}."
        )


def _dead_segment_index(rows: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 rows with every row outside ``[0, num_segments)`` sent to the
    extra segment ``num_segments``."""
    valid = (rows >= 0) & (rows < num_segments)
    return torch.where(valid, rows.to(torch.int64), num_segments)


def segment_sum_plain(
    vals: torch.Tensor, rows: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Plain PyTorch segment sum: ``index_add_`` into ``num_segments + 1``
    segments, where the extra one takes every out-of-range row and is cut
    off. Returns ``(num_segments,) + vals.shape[1:]`` in ``vals``' type."""
    _check(vals, rows, num_segments)
    _check_sum_dtype(vals)
    idx = _dead_segment_index(rows, num_segments)
    out = torch.zeros((num_segments + 1,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    out.index_add_(0, idx, vals)
    return out[:num_segments]


def segment_sum(vals: torch.Tensor, rows: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``(num_segments,) + vals.shape[1:]`` sums of ``vals`` (N, ...) by
    ``rows`` (N,), in ``vals``' type.

    A CPU tensor runs :func:`segment_sum_plain`. A CUDA tensor launches the
    kernel on PyTorch's current stream, without synchronising, and adds one
    to ``segment_sum.launches``; an empty stream, segment axis or lane axis
    launches nothing and gives zeros."""
    _check(vals, rows, num_segments)
    _check_sum_dtype(vals)
    if _build.runs_plain(vals):
        return segment_sum_plain(vals, rows, num_segments)
    lib = _build.library()
    tail = vals.shape[1:]
    flat = vals.reshape(vals.shape[0], math.prod(tail)).contiguous()
    rows = rows.contiguous()
    _build.require_cuda("segment_sum", flat, rows)
    n, d = flat.shape
    out = torch.zeros((num_segments, d), dtype=vals.dtype, device=vals.device)
    if n == 0 or d == 0 or num_segments == 0:
        return out.reshape((num_segments,) + tail)
    with torch.cuda.device(flat.device):
        err = lib.tc_segment_sum(
            _VAL_CODES[flat.dtype],
            _ROW_CODES[rows.dtype],
            flat.data_ptr(),
            rows.data_ptr(),
            n,
            d,
            num_segments,
            out.data_ptr(),
            _build.stream_of(flat),
        )
    _build.check(err, "segment_sum")
    segment_sum.launches += 1
    return out.reshape((num_segments,) + tail)


segment_sum.launches = 0


def _reduce_identity(reduce: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf") if reduce == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if reduce == "max" else info.max


def _segment_extremum(
    vals: torch.Tensor, rows: torch.Tensor, num_segments: int, reduce: str
) -> torch.Tensor:
    """Segment max or min: ``scatter_reduce_`` into the reduce's identity,
    out-of-range rows sent to a dead extra segment that is cut off."""
    if vals.dtype == torch.bool or vals.is_complex():
        raise TypeError(f"segment {reduce} takes real values, got {vals.dtype}.")
    flat = vals.reshape(vals.shape[0], math.prod(vals.shape[1:]))
    idx = _dead_segment_index(rows, num_segments)[:, None].expand(flat.shape)
    out = torch.full(
        (num_segments + 1, flat.shape[1]),
        _reduce_identity(reduce, vals.dtype),
        dtype=vals.dtype,
        device=vals.device,
    )
    out.scatter_reduce_(0, idx, flat, reduce=_SCATTER_REDUCE[reduce], include_self=True)
    return out[:num_segments].reshape((num_segments,) + vals.shape[1:])


def segment_scatter(
    vals: torch.Tensor,
    rows: torch.Tensor,
    num_segments: int,
    *,
    reduce: str = "sum",
    method: str = "auto",
) -> torch.Tensor:
    """Reduce per-sample rows ``vals[i]`` into segment ``rows[i]`` of a
    leading ``[num_segments]`` axis: the one entry point the sliced fold
    scatters through. ``reduce`` is ``"sum"``, ``"max"`` or ``"min"``;
    ``method`` is ``"auto"``, ``"kernel"`` (sum only) or ``"torch"``; see the
    module doc."""
    if reduce not in _REDUCES:
        raise ValueError(f"reduce must be one of {_REDUCES}, got {reduce!r}.")
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}.")
    if method == "kernel" and reduce != "sum":
        raise ValueError(
            f"method='kernel' supports reduce='sum' only (the kernel has no "
            f"{reduce!r} form); use method='auto' or 'torch'."
        )
    _check(vals, rows, num_segments)
    if reduce != "sum":
        return _segment_extremum(vals, rows, num_segments, reduce)
    if method == "torch":
        return segment_sum_plain(vals, rows, num_segments)
    return segment_sum(vals, rows, num_segments)
