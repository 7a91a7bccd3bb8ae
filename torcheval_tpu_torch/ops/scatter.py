"""Segment scatter: per-sample deltas reduced into a leading segment axis.

JAX counterpart: ``torcheval_tpu/ops/scatter.py`` (``segment_scatter``
with its ``mesh``/``axis`` route, ``_resolve_method``, ``_apply_local``,
``pallas_segment_sum`` with its Pallas kernel ``_scatter_kernel``, and
``sharded_pallas_segment_sum``). The
sliced collection (``metrics/sliced.py``) folds every batch through
:func:`segment_scatter`: ``out[r] = reduce(vals[i] for rows[i] == r)`` for
``r`` in ``[0, num_segments)``; rows outside that range (negative or
``>= num_segments``) are dropped.

* :func:`segment_sum` is the kernel's wrapper, the counterpart of
  ``pallas_segment_sum``: a CUDA tensor launches ``csrc/scatter.cu`` and
  counts the launch (``jit.calls{entry=segment_sum}``); a CPU tensor runs
  :func:`segment_sum_plain` (``index_add_`` into a dead extra segment that
  is cut off), which the tests and ``chip_smoke.py`` also hold the kernel
  against. Values are int32, int64, float32, float64, bfloat16 or float16
  and keep their type; other types raise ``TypeError``. Half-precision
  values add in their own type on the CPU, as the JAX package's XLA route
  adds them there; the kernel has no half-precision form, so on the card
  they add as float32 and each segment's sum is rounded once to the half
  type: within the float32 bound below of the exact sum, plus ``u`` of the
  half type times that float32 sum. The TPU kernel sums a float32 one-hot
  product, exact for integers to 2^24 a segment and only inside a segment
  envelope; the CUDA kernel adds with atomics of the values' own type, so
  integer sums are exact (and wrap like XLA's scatter-add, the JAX
  package's reference route) for any segment count, and ``auto`` sends every
  sum on a CUDA tensor to it.
* Where the kernel keeps its sums is chosen by the output's size alone,
  in :func:`segment_sum_route`. Each block keeps the output's first rows
  (its head) in shared memory. An output of up to 16 KiB fits the head
  whole (``local``). In one of up to 1 MiB the rows past the head are
  spread over the shared memory of a cluster of 2, 4 or 8 blocks, 128 KiB
  or less a block, and their adds go there through distributed shared
  memory (``cluster``: a 2^16-bucket score sketch, ``Quantile``'s value
  fold). In a larger one they go to device memory (``head``). Each launch
  counts its route (``segment_sum.route{route=}``).
* :func:`score_segment_sum` launches the same kernel with a second row
  source: the binary score sketch's fold, its bucket ids, lanes and NaN
  test made inside the kernel from the scores and targets it reads once.
* Float sums, in the kernel and in the plain version alike, add in an order
  that is not the reference's (atomics on the card run in no fixed order),
  so they are not bitwise reproducible. The bound every route meets, for
  any order of adds, is ``|got - exact| <= (count - 1) * u * sum(|v|)`` per
  segment and lane, with ``count`` the segment's number of samples and
  ``u`` = 2^-24 for float32, 2^-53 for float64, 2^-8 for bfloat16 and
  2^-11 for float16 (the bound of recursive
  summation); NaN and infinities propagate as in any sum.
* ``reduce="max"``/``"min"`` run ``scatter_reduce_`` (``amax``/``amin``)
  into a buffer filled with the reduce's identity (-inf or the integer
  minimum for max, +inf or the maximum for min), as the JAX package leaves
  them to XLA's ``segment_max``/``segment_min`` outside any Pallas kernel.
  NaN propagates to its segment, as in ``jax.ops.segment_max``.

Methods: ``"auto"`` and ``"kernel"`` (the JAX package's ``"pallas"``) run
:func:`segment_sum`, which launches the kernel on a CUDA tensor and runs the
plain version on a CPU one; ``"torch"`` runs the plain version on any
device, an explicit choice that nothing on the sliced path makes.

Sharded forms, one process per card:

* ``segment_scatter(..., mesh=, axis=)``, the block-range route of the
  sharded sliced collection: every rank of the ``DeviceMesh`` dim ``axis``
  sees the same ``vals``/``rows``, and rank ``r`` of ``S`` reduces into its
  own tile, the global segments ``[r*w, (r+1)*w)`` with ``w =
  num_segments / S``. No collective runs. The rows are localised to ``rows
  - r*w``, so a sum launches the kernel with ``w`` segments and every row
  of another rank's tile falls outside ``[0, w)``, where the kernel drops
  it before any atomic (the JAX route's explicit dead segment would be one
  hot row taking ``(S - 1) / S`` of every batch). A max or min masks those
  rows' values with the reduce's identity and spreads their indices over
  the tile (``local mod w``), so no row is hot and none changes.
* :func:`sharded_segment_sum`, the counterpart of
  ``sharded_pallas_segment_sum``: each rank sums its own samples, then one
  ``all_reduce(SUM)``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from torcheval_tpu_torch import _build
from torcheval_tpu_torch.obs import registry as _obs
from torcheval_tpu_torch.obs.cost import nbytes
from torcheval_tpu_torch.obs.recompile import count_launch, watched
from torcheval_tpu_torch.utils import dist as _dist

_METHODS = ("auto", "kernel", "torch")
_REDUCES = ("sum", "max", "min")
# the kernel's type codes (csrc/scatter.cu, tc_segment_sum)
_VAL_CODES = {torch.int32: 0, torch.int64: 1, torch.float32: 2, torch.float64: 3}
_ROW_CODES = {torch.int32: 0, torch.int64: 1}
_SCATTER_REDUCE = {"max": "amax", "min": "amin"}
# csrc/scatter.cu's shared memory: the head's single rows beside its hot
# rows' lane copies (kHeadBytes - kHotBytes), and a cluster block's slice
# in the cluster route, at most _MAX_CLUSTER blocks a cluster
_LOCAL_BYTES = 16 * 1024
_SLICE_BYTES = 128 * 1024
_MAX_CLUSTER = 8


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


# half-precision values: the plain version adds in their own type, in
# sample order, as XLA's scatter-add does on the CPU; the kernel route adds
# them as float32 and rounds each segment's sum once
_HALF = (torch.bfloat16, torch.float16)


def _check_sum_dtype(vals: torch.Tensor) -> None:
    if vals.dtype not in _VAL_CODES and vals.dtype not in _HALF:
        raise TypeError(
            "segment_sum takes int32, int64, float32, float64, bfloat16 or float16 "
            f"values, got {vals.dtype}."
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


def segment_sum_route(dtype: torch.dtype, d: int, num_segments: int) -> Tuple[str, int]:
    """The kernel's route for a ``(num_segments, d)`` output of ``dtype``
    (one of the kernel's four value types), and its cluster size:
    ``("local", 1)`` where the whole output fits the 16 KiB beside a
    block's hot rows, ``("cluster", c)`` with ``c`` the fewest blocks of 2,
    4 or 8 whose 128 KiB slices hold the output's rows, ``("head", 1)``
    past that. The one place the route is chosen: ``csrc/scatter.cu``
    takes the cluster size as given."""
    row = d * dtype.itemsize
    if num_segments * row <= _LOCAL_BYTES:
        return "local", 1
    per_block = _SLICE_BYTES // row
    if num_segments <= _MAX_CLUSTER * per_block:
        c = 2
        while c * per_block < num_segments:
            c *= 2
        return "cluster", c
    return "head", 1


def _segment_sum_cost(args, kwargs, out):
    """The values and rows read once, the sums written once; a float
    value adds once."""
    vals, rows = args[0], args[1]
    adds = vals.numel() if vals.dtype.is_floating_point else 0
    moved = nbytes(vals, rows, out)
    return adds, moved, moved


def _count_sum_launch(err: int, what: str, route: str, cost, args, out) -> None:
    """Every segment-sum kernel launch ends here: the C entry's error
    checked, the launch counted as the segment sum's
    (``jit.calls{entry=segment_sum}`` and its bytes by ``cost``) and its
    route (``segment_sum.route{route=}``)."""
    _build.check(err, what)
    count_launch("segment_sum", cost, args, out)
    if _obs._enabled:
        _obs.counter("segment_sum.route", route=route)


@watched(name="segment_sum", cost=_segment_sum_cost, counts_launches=True)
def segment_sum(vals: torch.Tensor, rows: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``(num_segments,) + vals.shape[1:]`` sums of ``vals`` (N, ...) by
    ``rows`` (N,), in ``vals``' type.

    A CPU tensor runs :func:`segment_sum_plain`. A CUDA tensor launches the
    kernel on PyTorch's current stream, without synchronising, and counts
    the launch (``jit.calls{entry=segment_sum}``); an empty stream, segment
    axis or lane axis launches nothing and gives zeros."""
    _check(vals, rows, num_segments)
    _check_sum_dtype(vals)
    if _build.runs_plain(vals):
        return segment_sum_plain(vals, rows, num_segments)
    if vals.dtype in _HALF:
        return segment_sum(vals.to(torch.float32), rows, num_segments).to(vals.dtype)
    lib = _build.library()
    tail = vals.shape[1:]
    flat = vals.reshape(vals.shape[0], math.prod(tail)).contiguous()
    rows = rows.contiguous()
    _build.require_cuda("segment_sum", flat, rows)
    n, d = flat.shape
    out = torch.zeros((num_segments, d), dtype=vals.dtype, device=vals.device)
    if n == 0 or d == 0 or num_segments == 0:
        return out.reshape((num_segments,) + tail)
    route, cluster = segment_sum_route(flat.dtype, d, num_segments)
    with torch.cuda.device(flat.device):
        err = lib.tc_segment_sum(
            _VAL_CODES[flat.dtype],
            _ROW_CODES[rows.dtype],
            flat.data_ptr(),
            rows.data_ptr(),
            n,
            d,
            num_segments,
            cluster,
            out.data_ptr(),
            _build.stream_of(flat),
        )
    _count_sum_launch(err, "segment_sum", route, _segment_sum_cost, (flat, rows), out)
    return out.reshape((num_segments,) + tail)


# the fused score fold's target codes (csrc/scatter.cu, tc_score_segment_sum)
_TARGET_CODES = {torch.int32: 0, torch.float32: 2}


def _score_segment_sum_cost(args, kwargs, out):
    """Each row's float32 score and 4-byte target read once, whatever the
    caller's types, the counts and the NaN count written once; no float
    add."""
    moved = args[0].numel() * 8 + nbytes(*out)
    return 0, moved, moved


@watched(name="segment_sum", cost=_score_segment_sum_cost, counts_launches=True)
def score_segment_sum(
    scores: torch.Tensor, targets: torch.Tensor, bucket_bits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The binary score sketch's fold (``sketch/histogram.py::
    score_hist_fold``) on the card in one launch of the segment-sum kernel:
    ``(2^bucket_bits, 2)`` int32 ``[t, 1 - t]`` sums by float-prefix bucket
    of ``(N,)`` CUDA scores and targets, and the int32 count of NaN scores
    (which add nothing).

    The kernel reads each row's score and target once and makes the bucket
    id, the lanes and the NaN test in registers (``csrc/scatter.cu``'s score
    source), bit for bit what ``score_hist_fold_plain`` makes from them, on
    the route :func:`segment_sum_route` gives the int32 output. Scores of
    another type are cast to float32 first, targets of a type other than
    float32 or int32 to int32, as the plain version casts them. It counts
    the launch as the segment sum's (``jit.calls{entry=segment_sum}``, under
    a ``jit/segment_sum`` range), its route (``segment_sum.route{route=}``)
    and ``sketch.fused_folds{kind=score}``. An empty stream launches
    nothing. There is no plain version here: the fold's caller runs it on
    a CPU tensor."""
    if scores.ndim != 1 or targets.shape != scores.shape:
        raise ValueError(
            "score_segment_sum wants scores (N,) with targets (N,), got "
            f"{tuple(scores.shape)} / {tuple(targets.shape)}."
        )
    lib = _build.library()
    scores = scores.to(torch.float32).contiguous()
    if targets.dtype not in _TARGET_CODES:
        targets = targets.to(torch.int32)
    targets = targets.contiguous()
    _build.require_cuda("score_segment_sum", scores, targets)
    num = 1 << bucket_bits
    # the counts and the NaN count in one zeroed buffer: one memset
    buf = torch.zeros(2 * num + 1, dtype=torch.int32, device=scores.device)
    hist, nan = buf[: 2 * num].view(num, 2), buf[2 * num]
    n = scores.shape[0]
    if n == 0:
        return hist, nan
    route, cluster = segment_sum_route(torch.int32, 2, num)
    with torch.cuda.device(scores.device):
        err = lib.tc_score_segment_sum(
            _TARGET_CODES[targets.dtype],
            scores.data_ptr(),
            targets.data_ptr(),
            n,
            bucket_bits,
            cluster,
            hist.data_ptr(),
            nan.data_ptr(),
            _build.stream_of(scores),
        )
    _count_sum_launch(err, "score_segment_sum", route, _score_segment_sum_cost,
                      (scores, targets), (hist, nan))
    if _obs._enabled:
        _obs.counter("sketch.fused_folds", kind="score")
    return hist, nan


def _reduce_identity(reduce: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf") if reduce == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if reduce == "max" else info.max


def _check_real(vals: torch.Tensor, reduce: str) -> None:
    if vals.dtype == torch.bool or vals.is_complex():
        raise TypeError(f"segment {reduce} takes real values, got {vals.dtype}.")


def _segment_extremum(
    vals: torch.Tensor, rows: torch.Tensor, num_segments: int, reduce: str
) -> torch.Tensor:
    """Segment max or min: ``scatter_reduce_`` into the reduce's identity,
    out-of-range rows sent to a dead extra segment that is cut off."""
    _check_real(vals, reduce)
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


def _tile_extremum(
    vals: torch.Tensor, local: torch.Tensor, w: int, reduce: str
) -> torch.Tensor:
    """Segment max or min into a ``w``-row tile from localised rows: rows
    outside ``[0, w)`` carry the reduce's identity to row ``local mod w``."""
    _check_real(vals, reduce)
    ok = (local >= 0) & (local < w)
    ident = _reduce_identity(reduce, vals.dtype)
    masked = torch.where(ok.reshape((-1,) + (1,) * (vals.ndim - 1)), vals, ident)
    return _segment_extremum(masked, torch.remainder(local, w), w, reduce)


def segment_scatter(
    vals: torch.Tensor,
    rows: torch.Tensor,
    num_segments: int,
    *,
    reduce: str = "sum",
    method: str = "auto",
    mesh=None,
    axis: str = None,
) -> torch.Tensor:
    """Reduce per-sample rows ``vals[i]`` into segment ``rows[i]`` of a
    leading ``[num_segments]`` axis: the one entry point the sliced fold
    scatters through. ``reduce`` is ``"sum"``, ``"max"`` or ``"min"``;
    ``method`` is ``"auto"``, ``"kernel"`` (sum only) or ``"torch"``; see the
    module doc.

    With ``mesh`` (a ``DeviceMesh``) and ``axis`` (one of its dim names),
    returns this rank's ``(num_segments / S,) + vals.shape[1:]`` tile of
    the result (the block-range route of the module doc);
    ``num_segments`` must be a multiple of the dim's size ``S``."""
    if reduce not in _REDUCES:
        raise ValueError(f"reduce must be one of {_REDUCES}, got {reduce!r}.")
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}.")
    if method == "kernel" and reduce != "sum":
        raise ValueError(
            f"method='kernel' supports reduce='sum' only (the kernel has no "
            f"{reduce!r} form); use method='auto' or 'torch'."
        )
    if (mesh is None) != (axis is None):
        raise ValueError("mesh and axis must be passed together.")
    _check(vals, rows, num_segments)
    if _obs._enabled:
        _count_scatter(vals, num_segments, reduce, method, mesh, axis)
    if mesh is not None:
        ax = _dist.mesh_axis(mesh, axis)
        if num_segments % ax.size:
            raise ValueError(
                f"num_segments {num_segments} is not a multiple of mesh axis {axis!r} "
                f"size {ax.size}: the block-range route needs equal per-rank tiles (the "
                "sliced collection rounds its capacity up)."
            )
        num_segments //= ax.size
        rows = rows - ax.rank * num_segments
        if reduce != "sum":
            return _tile_extremum(vals, rows, num_segments, reduce)
    elif reduce != "sum":
        return _segment_extremum(vals, rows, num_segments, reduce)
    if method == "torch":
        return segment_sum_plain(vals, rows, num_segments)
    return segment_sum(vals, rows, num_segments)


def _count_scatter(vals, num_segments: int, reduce: str, method: str, mesh, axis) -> None:
    """``ops.scatter.calls{path=}`` (``sharded``, ``cuda`` for the kernel,
    ``torch`` for the plain and library routes) and the segment-axis state
    bytes a rank holds."""
    shards = 1
    if mesh is not None:
        path, shards = "sharded", _dist.mesh_axis(mesh, axis).size
    elif reduce == "sum" and method != "torch" and not _build.runs_plain(vals):
        path = "cuda"
    else:
        path = "torch"
    _obs.counter("ops.scatter.calls", path=path)
    lanes = math.prod(vals.shape[1:])
    _obs.gauge(
        "ops.scatter.state_bytes_per_device",
        float(num_segments // shards * lanes * vals.element_size()),
        path=path,
    )


def sharded_segment_sum(
    vals: torch.Tensor, rows: torch.Tensor, num_segments: int, group=None
) -> torch.Tensor:
    """``(num_segments,) + vals.shape[1:]`` sums of every rank's samples in
    ``group`` (the whole ``torch.distributed`` world for None):
    :func:`segment_sum` over this rank's ``vals``/``rows``, then one
    ``all_reduce(SUM)``, staged through the host for gloo. The result is on
    ``vals``' device on every rank; with no world it is :func:`segment_sum`
    and no collective runs. Float sums add the ranks' partial sums in the
    backend's order, within the module's bound.

    JAX counterpart: ``sharded_pallas_segment_sum`` (``scatter.py:324-390``),
    whose partitioning rule runs the kernel on each shard's samples and
    folds the partials with one ``psum``."""
    local = segment_sum(vals, rows, num_segments)
    if not _dist.initialized():
        return local
    return _dist.all_reduce_sum(local, group)
