"""Sort-based ROC / PR curve functions, binary and one-vs-all multiclass.

JAX counterpart: ``torcheval_tpu/ops/curves.py`` (the names are kept so each
function's twin is easy to find, and a ``_kernel`` suffix here names a plain
PyTorch function, not a CUDA kernel). Where the JAX package ``vmap``s a
binary function over the class axis, the functions here work along the
last axis of ``(C, N)`` columns directly: one batched sort, and tie groups
that never cross a class row (``ops/summary.py::tie_groups``).

Scores sort descending with the counts carried along, and cumulative TP/FP
counts are taken in int32. Every position then takes the cumulative counts
of the last row of its tie group (by group id, ``ops/summary.py::group_value``),
so points inside a tie group coincide with the group end: the trapezoid
gets zero-width segments inside a group and the tie diagonal across it, and
the step integral gets zero delta-TP inside a group. Rows with a NaN score
are padding: they sort last, never join a tie group, and carry zero counts.

On the card, :func:`binary_auroc_kernel` (and :func:`binary_auroc_parts`,
a raw cache's parts as they lie) sends a 1-D score column to the
stream route (``ops/roc_stream.py``): one stable radix sort of (order key,
one-byte label) pairs and one hand kernel over the tie-group ends, with no
index permutation and no group-end propagation. Everything else takes the
composition above, which stays the stream route's reference: the CPU,
``(C, N)`` rows, targets whose int32 cast is not 0 or 1, the counts and
presorted kernels, the AUPRC and the PR points. Each call counts its route
in ``curves.auroc_route{route=stream|composition}``.

Every ``_kernel`` function is watched by the recompile watchdog
(``obs/recompile.py``) under its own name, as its JAX twin is a
``watched_jit`` entry.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torcheval_tpu_torch import _build
from torcheval_tpu_torch.obs import registry as _obs
from torcheval_tpu_torch.obs.recompile import watched
from torcheval_tpu_torch.ops import roc_stream
from torcheval_tpu_torch.ops.summary import group_value, sort_descending, tie_groups


def _propagate_group_ends(
    s: torch.Tensor, ctp: torch.Tensor, cfp: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Replace each position's cumulative counts with those at the END of
    its tie group (the JAX package's reverse ``cummin`` over the
    group-end-masked cumsums; here a scatter and gather by group id, see
    ``ops/summary.py::group_value``), and the group-end mask."""
    gid, _, last = tie_groups(s)
    return group_value(gid, last, ctp), group_value(gid, last, cfp), last


def _group_end_cumsums(input: torch.Tensor, target: torch.Tensor):
    """Raw samples (unit counts): only the target rides the sort, and the
    FP cumsum is ``rank + 1 - cumsum(tp)``. Returns ``(s, tp, fp, last)``
    along the last axis."""
    s, (t,) = sort_descending(input, target.to(torch.int32))
    ctp = torch.cumsum(t, -1, dtype=torch.int32)
    cfp = torch.arange(1, s.shape[-1] + 1, dtype=torch.int32, device=s.device) - ctp
    return (s, *_propagate_group_ends(s, ctp, cfp))


def _group_end_count_cumsums(
    scores: torch.Tensor, tp_w: torch.Tensor, fp_w: torch.Tensor
):
    """(score, tp_count, fp_count) rows: a raw sample is the unit case
    ``(s, t, 1 - t)``; a summary row carries aggregated counts. int32
    cumulative counts are exact while total positives and negatives each
    stay below 2^31."""
    s, (tp_c, fp_c) = sort_descending(
        scores, tp_w.to(torch.int32), fp_w.to(torch.int32)
    )
    ctp = torch.cumsum(tp_c, -1, dtype=torch.int32)
    cfp = torch.cumsum(fp_c, -1, dtype=torch.int32)
    return _propagate_group_ends(s, ctp, cfp)[:2]


def _auroc_from_group_ends(itp: torch.Tensor, ifp: torch.Tensor) -> torch.Tensor:
    """Trapezoidal integration over group-end TP/FP counts along the last
    axis; 0.5 when the targets are all one or all zero."""
    zero = itp.new_zeros(itp.shape[:-1] + (1,))
    tp = torch.cat([zero, itp], -1).to(torch.float32)
    fp = torch.cat([zero, ifp], -1).to(torch.float32)
    factor = tp[..., -1] * fp[..., -1]
    auc = torch.trapezoid(tp, fp)
    return torch.where(factor == 0, 0.5, auc / torch.clamp(factor, min=1.0))


def _auprc_from_group_ends(itp: torch.Tensor, ifp: torch.Tensor) -> torch.Tensor:
    """Average precision (step integration) over group-end TP/FP counts
    along the last axis: ``sum(delta_tp * precision) / tp_total``; 0.0 with
    no positives."""
    tp = itp.to(torch.float32)
    fp = ifp.to(torch.float32)
    precision = tp / torch.clamp(tp + fp, min=1.0)
    delta_tp = torch.diff(itp, prepend=itp.new_zeros(itp.shape[:-1] + (1,))).to(torch.float32)
    total = tp[..., -1]
    ap = torch.sum(delta_tp * precision, -1) / torch.clamp(total, min=1.0)
    return torch.where(total == 0, 0.0, ap)


@watched
def binary_auroc_counts_kernel(scores, tp_w, fp_w) -> torch.Tensor:
    """Exact trapezoidal AUROC over (score, tp_count, fp_count) rows, along
    the last axis."""
    tp, fp = _group_end_count_cumsums(scores, tp_w, fp_w)
    return _auroc_from_group_ends(tp, fp)


@watched
def binary_auprc_counts_kernel(scores, tp_w, fp_w) -> torch.Tensor:
    """Average precision over (score, tp, fp) count rows, along the last
    axis."""
    if scores.shape[-1] == 0:
        return torch.zeros(scores.shape[:-1], device=scores.device)
    tp, fp = _group_end_count_cumsums(scores, tp_w, fp_w)
    return _auprc_from_group_ends(tp, fp)


@watched
def binary_auroc_counts_presorted_kernel(scores, tp_w, fp_w) -> torch.Tensor:
    """AUROC over rows ALREADY sorted descending, tie-merged and
    (NaN, 0, 0)-padded, as every ``compact_counts`` output is: each row is
    its own tie group, so the cumsums feed the trapezoid with no sort. Along
    the last axis: ``(C, K)`` per-class columns give ``(C,)``."""
    if scores.shape[-1] == 0:
        return torch.full(scores.shape[:-1], 0.5, device=scores.device)
    ctp = torch.cumsum(tp_w, -1, dtype=torch.int32)
    cfp = torch.cumsum(fp_w, -1, dtype=torch.int32)
    return _auroc_from_group_ends(ctp, cfp)


@watched
def binary_auprc_counts_presorted_kernel(scores, tp_w, fp_w) -> torch.Tensor:
    """Average precision over presorted tie-merged count rows."""
    if scores.shape[-1] == 0:
        return torch.zeros(scores.shape[:-1], device=scores.device)
    ctp = torch.cumsum(tp_w, -1, dtype=torch.int32)
    cfp = torch.cumsum(fp_w, -1, dtype=torch.int32)
    return _auprc_from_group_ends(ctp, cfp)


def _takes_stream(inputs, targets) -> bool:
    """True for the stream route's inputs: 1-D score columns off the CPU,
    of one type that float32 holds exactly, each with 1-D targets of its
    length and of one type, fewer than 2^31 rows in all."""
    if not inputs or len(inputs) != len(targets):
        return False
    x, t = inputs[0], targets[0]
    return (
        not _build.runs_plain(x)
        and x.dtype in roc_stream.STREAM_SCORES
        and all(a.ndim == 1 and a.dtype == x.dtype for a in inputs)
        and all(b.shape == a.shape and b.dtype == t.dtype for a, b in zip(inputs, targets))
        and sum(a.shape[0] for a in inputs) < 1 << 31
    )


def _count_route(route: str) -> None:
    if _obs._enabled:
        _obs.counter("curves.auroc_route", route=route)


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _binary_auroc(inputs, targets) -> torch.Tensor:
    """The exact AUROC of lists of parts by the stream route where they
    take it and their targets are 0 or 1, else by the composition of their
    concatenation; one ``curves.auroc_route`` a call."""
    if _takes_stream(inputs, targets):
        auc = roc_stream.binary_auroc_stream(inputs, targets)
        if auc is not None:
            _count_route("stream")
            return auc
    _count_route("composition")
    return auroc_composition(_cat(inputs), _cat(targets))


@watched
def binary_auroc_kernel(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Exact trapezoidal AUROC on raw samples (along the last axis)."""
    return _binary_auroc([input], [target])


def binary_auroc_parts(inputs, targets) -> torch.Tensor:
    """:func:`binary_auroc_kernel` over a raw cache's parts (lists of
    tensors). Parts that take the stream route, more than one, go to it as
    they lie, with no concatenated copy and no watched entry; anything
    else goes to :func:`binary_auroc_kernel`, more parts concatenated
    first, as the JAX package concatenates its cache."""
    if len(inputs) > 1 and _takes_stream(inputs, targets):
        return _binary_auroc(inputs, targets)
    return binary_auroc_kernel(_cat(inputs), _cat(targets))


def auroc_composition(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """:func:`binary_auroc_kernel`'s composition, whatever the device: the
    stream route's reference, which ``chip_smoke.py`` times beside it."""
    _, tp, fp, _ = _group_end_cumsums(input, target)
    return _auroc_from_group_ends(tp, fp)


@watched
def binary_auprc_kernel(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Average precision on raw samples (along the last axis)."""
    if input.shape[-1] == 0:
        return torch.zeros(input.shape[:-1], device=input.device)
    _, tp, fp, _ = _group_end_cumsums(input, target)
    return _auprc_from_group_ends(tp, fp)


@watched
def prc_points_kernel(
    input: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-length PR-curve points in descending-threshold order, and the
    "last of its tie group" mask, along the last axis. The caller selects
    the ``mask`` rows on the host and flips them to ascending order (the
    reference layout). With no positives, recall is 1.0 everywhere."""
    if input.shape[-1] == 0:
        empty = torch.empty(input.shape, device=input.device)
        return empty, empty, empty, torch.zeros(input.shape, dtype=torch.bool, device=input.device)
    s, itp, ifp, last = _group_end_cumsums(input, target)
    tp = itp.to(torch.float32)
    fp = ifp.to(torch.float32)
    precision = tp / torch.clamp(tp + fp, min=1.0)
    total_pos = tp[..., -1:]
    recall = torch.where(total_pos > 0, tp / torch.clamp(total_pos, min=1.0), 1.0)
    return s, precision, recall, last


@watched
def multiclass_prc_points_kernel(scores: torch.Tensor, onehot: torch.Tensor):
    """:func:`prc_points_kernel` over ``(C, N)`` one-vs-all rows: the JAX
    package's ``vmap`` of it over the class axis, as one batched sort."""
    return prc_points_kernel(scores, onehot)


def class_onehot_rows(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``(C, N)`` float32 one-vs-all membership rows from ``(N,)`` integer
    labels (cast to int32 first, as JAX casts them; out-of-range labels
    match no class)."""
    classes = torch.arange(num_classes, dtype=torch.int32, device=target.device)
    return (target.to(torch.int32)[None, :] == classes[:, None]).to(torch.float32)


@watched
def multiclass_auroc_kernel(scores: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-class one-vs-all AUROC ``(C,)`` from ``(N, C)`` scores and ``(N,)``
    integer labels: the binary function over the ``(C, N)`` rows."""
    onehot = class_onehot_rows(target, scores.shape[1])
    return binary_auroc_kernel(scores.T, onehot)


@watched
def multiclass_auprc_kernel(scores: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-class one-vs-all average precision, batched as
    :func:`multiclass_auroc_kernel`."""
    onehot = class_onehot_rows(target, scores.shape[1])
    return binary_auprc_kernel(scores.T, onehot)
