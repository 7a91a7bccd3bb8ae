"""Distributed exact curves over a process group: a bucket exchange and a
sort on each rank, where a gather would bring every rank's rows to every
rank.

JAX counterpart: ``torcheval_tpu/ops/dist_curves.py``, with the same public
names and contracts. There one program runs over the devices of a mesh
axis and the rows of a sharded cache are that axis's blocks. Here each rank
of a ``torch.distributed`` group holds its own rows (row counts may differ,
a rank may hold none) and passes the group: a process group, None for the
whole world, or a ``DeviceMesh`` dim resolved by ``utils/dist.py::mesh_axis``
(a dim that is a subset of the world runs its own exchange, as a sub-axis
of a JAX mesh does). The steps are the JAX package's:

1. **Order keys** (:func:`order_key`): ascending key order is descending
   score order, equal scores get equal keys (-0.0 is made +0.0 first), and
   every NaN gets the pad key, which sorts last. torch has no usable uint32
   sort, so the JAX package's uint32 key is held as int32 with the sign bit
   flipped, which orders as the uint32 does; its top 16 bits, offset into
   ``[0, 2^16)``, are the splitter bins.
2. **Splitter histogram**: the bins of the rank's keys, counted by the
   histogram kernel (``ops/hist.py``, ``csrc/hist.cu``; 2^16 bins) for a
   binary problem and, for ``C`` classes, by one segment sum of int32 ones
   over ``c * 2^16 + bin`` (``ops/scatter.py``, ``csrc/scatter.cu``), then
   summed over the group in one int32 all-reduce. Its last bin holds
   exactly the NaN entries (no float's key shares the pad key's top 16
   bits), and one extra lane carries each rank's abstention (below). The
   boundaries are the K-quantile bins of the cumulative histogram, in
   float32 by ``searchsorted``, as the JAX package takes them.
3. **Exchange**: each rank sorts its entries once (``torch.sort`` of an
   int64 of destination bucket, class and key: every class's buckets in
   destination order), cuts them into K contiguous buckets and sends each
   with one ragged all-to-all (``utils/dist.py::all_to_all_rows``) of
   ``(key, label)`` int32 rows, every class's buckets in the same call.
   Equal keys share a bucket, so a tie group never spans two ranks.
4. **Capacity**: a bucket sends at most ``ceil(F * n_local / K)`` rows
   (``F = DIST_CAPACITY_FACTOR``), with ``n_local = ceil(total / K)`` and
   ``total`` the global row count read from the summed histogram (the JAX
   formula at even splits). Rows past it are not sent and are counted
   exactly: every rank's send counts and overflow ride one small
   all-gather, which also gives each rank its receive counts.
5. **Merge**: each rank sorts what it received (class, then key), takes
   the local cumulative counts, the global offsets from the per-rank
   totals (one small all-gather), and the trapezoid (AUROC) or step
   (AUPRC) integral in float32 as the JAX bodies do; one more all-reduce
   sums the K partial integrals. The empty-target guards give 0.5 (AUROC)
   and 0.0 (AUPRC).

**Collectives**: every call makes exactly five, whatever its class and row
counts: the splitter all-reduce, the count all-gather, the all-to-all, the
totals all-gather and the integral all-reduce (the JAX program: one
all-reduce, three all-to-alls and three more all-reduces). A call where
some rank abstained stops after the first, on every rank.

**Error channel**: each function returns ``(value, error_rows)``, where
``error_rows`` counts the rows lost to capacity overflow plus the NaN-keyed
entries; a nonzero count means the value is not to be trusted, and the
caller falls back to the gather route, whose NaN order is the unsharded
one's. On even splits it equals the JAX function's count exactly.

**The route's decision** (``metrics/classification/auroc.py``): a rank
decides only about its own cache, so a rank whose cache holds summary rows
abstains through the splitter all-reduce's lane, and every rank reads the
same sum; overflow and NaN are read from the same collective results. All
ranks take the same branch, and none waits in a collective another skipped.

**Sketch** (:func:`sharded_sketch_counts`): each rank folds its staged rows
with the sketch folds (``sketch/histogram.py``, on the segment-sum kernel),
then one exact int32 all-reduce of ``(tp, fp, nan)``, never quantized.

``quantize=`` is accepted and changes nothing: the wire codecs
(``utils/quant.py``) are not ported, so every collective carries raw
words. The JAX package's quantized exchange is bit-identical to the raw
one, so no value moves.

Not ported, by design: the JAX engine's detection of a sharded operand
(``auroc.py::_uniform_cache_mesh``), since a torch tensor carries no
sharding (the route takes the evaluator's group instead); and its
requirement that rows divide by the axis size, since ranks are ragged here.

Counters (plain attributes until ``obs/`` is ported; the JAX names in
brackets): ``exchange_buckets.calls`` [``dist_curves.exchanges``],
``exchange_buckets.send_bytes`` [``dist_curves.exchange_send_bytes``: the
bytes that entered the all-to-all] and ``record_call.calls``
[``ops.dist_curves.calls``: ``{(path, family): n}``, path ``dist``,
``fused`` or ``sketch``, family ``binary`` or ``multiclass``].
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from torcheval_tpu_torch.ops.hist import hist
from torcheval_tpu_torch.ops.scatter import segment_sum
from torcheval_tpu_torch.ops.summary import group_value, tie_groups
from torcheval_tpu_torch.sketch.histogram import mc_score_hist_fold, score_hist_fold
from torcheval_tpu_torch.utils import dist as _dist
from torcheval_tpu_torch.utils.dist import MeshAxis

__all__ = [
    "DIST_CAPACITY_FACTOR",
    "order_key",
    "sharded_binary_auroc",
    "sharded_binary_auprc",
    "sharded_multiclass_auroc",
    "sharded_multiclass_auprc",
    "sharded_sketch_counts",
]

# per-(source, destination) send capacity is ceil(F * n_local / K): F = 4
# absorbs heavy skew while keeping the exchange at most 4x the minimum
DIST_CAPACITY_FACTOR = 4
HIST_BINS = 1 << 16
# the JAX package's uint32 pad key 0xFFFFFFFF, sign bit flipped
PAD_KEY = 0x7FFFFFFF
_KEY_OFFSET = 1 << 31  # int32 key + 2^31 is the uint32 key

Group = Union[MeshAxis, "torch.distributed.ProcessGroup", None]


def record_call(path: str, family: str) -> None:
    """Count one compute of an exact or approximate curve metric by route."""
    key = (path, family)
    record_call.calls[key] = record_call.calls.get(key, 0) + 1


record_call.calls = {}


def _bucket_capacity(n_local: int, k: int) -> int:
    return max(1, -(-DIST_CAPACITY_FACTOR * n_local // k))


def order_key(scores: torch.Tensor) -> torch.Tensor:
    """int32 order keys of ``scores`` (any float type, any shape): ascending
    keys are descending scores, equal scores (+-0.0 included) equal keys,
    and every NaN the pad key :data:`PAD_KEY`, the largest. This is the JAX
    package's uint32 ``_desc_key`` with the sign bit flipped, which keeps
    the uint32 order in a signed type."""
    s = scores.to(torch.float32)
    s = torch.where(s == 0, 0.0, s)  # one key for both zeros
    b = s.view(torch.int32)
    key = torch.where(b < 0, b & 0x7FFFFFFF, ~b)
    return torch.where(torch.isnan(s), PAD_KEY, key)


def splitter_bins(key: torch.Tensor) -> torch.Tensor:
    """The top 16 bits of the uint32 key, as int32 in ``[0, 2^16)``."""
    return (key >> 16) + (1 << 15)


# each collective is the identity without a world, as the sharded kernel
# forms' are (ops/hist.py::sharded_class_counts)
def _all_reduce(t: torch.Tensor, pg) -> torch.Tensor:
    return _dist.all_reduce_sum(t, pg) if _dist.initialized() else t


def _all_gather(t: torch.Tensor, pg) -> torch.Tensor:
    return _dist.all_gather_stacked(t, pg).to(t.device) if _dist.initialized() else t[None]


def exchange_buckets(
    rows: torch.Tensor, send: List[int], recv: List[int], pg
) -> torch.Tensor:
    """The all-to-all of the bucket rows; counts the exchanges and the bytes
    that entered them."""
    exchange_buckets.calls += 1
    exchange_buckets.send_bytes += rows.numel() * rows.element_size()
    if not _dist.initialized():
        return rows
    return _dist.all_to_all_rows(rows, send, recv, pg)


exchange_buckets.calls = 0
exchange_buckets.send_bytes = 0


def _entries(s_list, t_list, multiclass: bool):
    """``(key (C, n), tp (C, n))`` int32 one-vs-all columns of a rank's raw
    blocks: unit counts, ``fp = 1 - tp``."""
    s = torch.cat(list(s_list), dim=0)
    t = torch.cat(list(t_list), dim=0).to(torch.int32)
    if not multiclass:
        return order_key(s)[None], t[None]
    classes = torch.arange(s.shape[1], dtype=torch.int32, device=s.device)
    return order_key(s.T), (t[None, :] == classes[:, None]).to(torch.int32)


def _splitter_counts(bins: torch.Tensor, multiclass: bool) -> torch.Tensor:
    """``(C, 2^16)`` int32 bin counts: the histogram kernel for one class,
    one segment sum over ``c * 2^16 + bin`` for several."""
    c = bins.shape[0]
    if not multiclass:
        return hist(bins.reshape(-1), HIST_BINS)[None]
    offset = torch.arange(c, dtype=torch.int32, device=bins.device)[:, None] * HIST_BINS
    combined = (bins + offset).reshape(-1)
    ones = torch.ones(combined.shape[0], dtype=torch.int32, device=bins.device)
    return segment_sum(ones, combined, c * HIST_BINS).reshape(c, HIST_BINS)


def curve_value(which: str, s_list, t_list, *, group: Group = None, abstain: bool = False):
    """One distributed curve call (``which`` is ``auroc``, ``auprc``,
    ``mc_auroc`` or ``mc_auprc``): ``(value, error_rows)``, or None on every
    rank when some rank passed ``abstain`` (the route's veto, which rides
    the first collective)."""
    multiclass = which.startswith("mc_")
    pg = _dist.process_group(group)
    k, me = _dist.world_size(pg), _dist.rank(pg)
    key, tp = _entries(s_list, t_list, multiclass)
    c, n = key.shape
    dev = key.device
    bins = splitter_bins(key)

    # 1. splitter histogram, summed, with the abstention lane
    lane = torch.tensor([int(abstain)], dtype=torch.int32, device=dev)
    summed = _all_reduce(torch.cat([_splitter_counts(bins, multiclass).reshape(-1), lane]), pg)
    counts = summed[:-1].reshape(c, HIST_BINS)
    abstained, total, nan_entries = (
        int(v) for v in torch.stack([summed[-1], counts[0].sum(), counts[:, -1].sum()]).tolist()
    )
    if abstained:
        return None
    cap = _bucket_capacity(-(-total // k), k)
    cum = torch.cumsum(counts, dim=1, dtype=torch.int32).to(torch.float32)
    targets = cum[:, -1:] * (torch.arange(1, k, dtype=torch.float32, device=dev) / float(k))
    boundaries = torch.searchsorted(cum, targets.contiguous(), side="left", out_int32=True)
    bucket = torch.searchsorted(boundaries, bins.contiguous(), side="right", out_int32=True)

    # 2. one local sort into destination-major (bucket, class, key) order
    cls = torch.arange(c, dtype=torch.int64, device=dev)[:, None]
    group_id = bucket.to(torch.int64) * c + cls
    comp, order = torch.sort(((group_id << 32) + (key.to(torch.int64) + _KEY_OFFSET)).reshape(-1))
    g_sorted = comp >> 32
    starts = torch.searchsorted(g_sorted, torch.arange(k * c, device=dev))
    ends = torch.cat([starts[1:], starts.new_tensor([comp.shape[0]])])
    per_group = ends - starts  # (K * C,), destination-major
    pos = torch.arange(comp.shape[0], device=dev) - starts[g_sorted]
    keep = pos < cap
    sent = per_group.clamp(max=cap).reshape(k, c).sum(dim=1)
    overflow = (per_group - cap).clamp(min=0).sum()
    label = tp.reshape(-1)[order]
    if multiclass:
        label = label + 2 * (order // n).to(torch.int32)  # class and tp in one word
    rows = torch.stack([((comp & 0xFFFFFFFF) - _KEY_OFFSET).to(torch.int32), label], dim=1)[keep]

    # 3. send and receive counts of every rank, the overflow with them
    matrix = _all_gather(torch.cat([sent, overflow[None]]), pg).tolist()
    error_rows = sum(m[k] for m in matrix) + nan_entries
    recv = [m[me] for m in matrix]
    got = exchange_buckets(rows, sent.tolist(), recv, pg)

    # 4. merge: class, then key; dense (C, W) rows padded with the pad key
    r_key, r_lab = got[:, 0], got[:, 1]
    r_cls = (r_lab >> 1).to(torch.int64) if multiclass else torch.zeros_like(r_lab, dtype=torch.int64)
    r_tp = r_lab & 1 if multiclass else r_lab
    _, r_order = torch.sort((r_cls << 32) + (r_key.to(torch.int64) + _KEY_OFFSET))
    r_key, r_tp, r_cls = r_key[r_order], r_tp[r_order], r_cls[r_order]
    c_starts = torch.searchsorted(r_cls, torch.arange(c, device=dev))
    c_ends = torch.cat([c_starts[1:], c_starts.new_tensor([r_cls.shape[0]])])
    width = max(int((c_ends - c_starts).max()), 1)
    at = torch.arange(r_cls.shape[0], device=dev) - c_starts[r_cls]
    d_key = torch.full((c, width), PAD_KEY, dtype=torch.int32, device=dev)
    d_tp = torch.zeros((c, width), dtype=torch.int32, device=dev)
    d_fp = torch.zeros((c, width), dtype=torch.int32, device=dev)
    d_key[r_cls, at] = r_key
    d_tp[r_cls, at] = r_tp
    d_fp[r_cls, at] = 1 - r_tp
    ctp = torch.cumsum(d_tp, dim=1, dtype=torch.int32)
    cfp = torch.cumsum(d_fp, dim=1, dtype=torch.int32)
    groups = tie_groups(d_key)

    # 5. global offsets from every rank's totals
    totals = _all_gather(torch.stack([ctp[:, -1], cfp[:, -1]], dim=1).to(torch.int64), pg)
    tp_off = totals[:me, :, 0].sum(dim=0)[:, None]
    fp_off = totals[:me, :, 1].sum(dim=0)[:, None]
    p_tot, n_tot = totals[..., 0].sum(dim=0), totals[..., 1].sum(dim=0)
    body = _auroc_body if which.endswith("auroc") else _auprc_body
    value = body(d_tp, ctp, cfp, groups, tp_off, fp_off, p_tot, n_tot, pg)
    return (value if multiclass else value[0]), error_rows


# The bodies take each tie group's end values by ops/summary.py's
# group_value (a scatter and a gather by group id) where the JAX bodies run
# a reverse cummin and a cummax: PyTorch's cummin/cummax along one long row
# measured about 300 ms per 10^8 rows on the card.
def _auroc_body(d_tp, ctp, cfp, groups, tp_off, fp_off, p_tot, n_tot, pg):
    """The offset trapezoid: every point at its tie group's end counts
    (zero-width segments inside a group), the rank's points at the global
    offsets, its float32 trapezoid, summed over the group."""
    gid, _, last = groups
    tp_end, fp_end = group_value(gid, last, ctp), group_value(gid, last, cfp)
    tp_pts = torch.cat([tp_off, tp_off + tp_end], dim=1).to(torch.float32)
    fp_pts = torch.cat([fp_off, fp_off + fp_end], dim=1).to(torch.float32)
    auc = _all_reduce(torch.trapezoid(tp_pts, fp_pts, dim=1), pg)
    factor = p_tot.to(torch.float32) * n_tot.to(torch.float32)
    return torch.where(factor == 0, 0.5, auc / torch.clamp(factor, min=1.0))


def _auprc_body(d_tp, ctp, cfp, groups, tp_off, fp_off, p_tot, n_tot, pg):
    """The step integral: per tie group the TP delta (its end's cumulative
    count less the count before its first row) times the precision at the
    global cumulative counts, summed over the group."""
    gid, first, last = groups
    before = group_value(gid, first, ctp - d_tp)
    delta_tp = torch.where(last, ctp - before, 0).to(torch.float32)
    ctp_g = (tp_off + ctp).to(torch.float32)
    cfp_g = (fp_off + cfp).to(torch.float32)
    prec = ctp_g / torch.clamp(ctp_g + cfp_g, min=1.0)
    ap = _all_reduce((delta_tp * prec).sum(dim=1), pg)
    total = p_tot.to(torch.float32)
    return torch.where(total == 0, 0.0, ap / torch.clamp(total, min=1.0))


def sharded_binary_auroc(
    s_list: Sequence[torch.Tensor],
    t_list: Sequence[torch.Tensor],
    *,
    group: Group = None,
    quantize=None,
) -> Tuple[torch.Tensor, int]:
    """Exact AUROC over every rank's raw ``(N_i,)`` score and target blocks
    without gathering the rows. Every rank of ``group`` calls it together
    (a rank with no rows passes an empty block). Returns ``(value,
    error_rows)`` on every rank: a nonzero count means a bucket overflowed
    its send capacity or some score is NaN, and the value is not to be
    trusted (module doc). ``quantize`` changes nothing (module doc)."""
    return curve_value("auroc", s_list, t_list, group=group)


def sharded_binary_auprc(
    s_list: Sequence[torch.Tensor],
    t_list: Sequence[torch.Tensor],
    *,
    group: Group = None,
    quantize=None,
) -> Tuple[torch.Tensor, int]:
    """Exact average precision over every rank's raw blocks; the contract
    of :func:`sharded_binary_auroc`."""
    return curve_value("auprc", s_list, t_list, group=group)


def sharded_multiclass_auroc(
    s_list: Sequence[torch.Tensor],
    t_list: Sequence[torch.Tensor],
    *,
    group: Group = None,
    quantize=None,
) -> Tuple[torch.Tensor, int]:
    """Exact one-vs-all per-class AUROC over every rank's raw ``(N_i, C)``
    score blocks and ``(N_i,)`` integer labels (a rank with no rows passes
    a ``(0, C)`` block): ``((C,) values, error_rows)``, every class's
    buckets in one exchange; the contract of :func:`sharded_binary_auroc`."""
    return curve_value("mc_auroc", s_list, t_list, group=group)


def sharded_multiclass_auprc(
    s_list: Sequence[torch.Tensor],
    t_list: Sequence[torch.Tensor],
    *,
    group: Group = None,
    quantize=None,
) -> Tuple[torch.Tensor, int]:
    """Exact one-vs-all per-class average precision; see
    :func:`sharded_multiclass_auroc`."""
    return curve_value("mc_auprc", s_list, t_list, group=group)


def sharded_sketch_counts(
    s_list: Sequence[torch.Tensor],
    t_list: Sequence[torch.Tensor],
    *,
    group: Group = None,
    bucket_bits: int,
    num_classes: Optional[int] = None,
    base: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every rank's staged rows folded into the global sketch histograms:
    each rank's sketch fold (one segment-sum launch), then one exact int32
    all-reduce. Returns ``(tp, fp, nan_count)`` on every rank, ``(B,)``
    binary or ``(C, B)`` one-vs-all with ``num_classes``. ``base``, a
    rank's resident ``(tp, fp, nan)``, is added before the all-reduce, so a
    resident sketch and its staging cross in the same round. No overflow
    channel: the histograms have a fixed size."""
    s = torch.cat(list(s_list), dim=0)
    t = torch.cat(list(t_list), dim=0)
    if num_classes is None:
        tp, fp, nan = score_hist_fold(s, t, bucket_bits)
    else:
        tp, fp, nan = mc_score_hist_fold(s, t, bucket_bits, num_classes)
    if base is not None:
        tp, fp, nan = tp + base[0], fp + base[1], nan + base[2]
    flat = torch.cat([tp.reshape(-1), fp.reshape(-1), nan.reshape(1)])
    summed = _all_reduce(flat, _dist.process_group(group))
    size = tp.numel()
    return summed[:size].reshape(tp.shape), summed[size : 2 * size].reshape(fp.shape), summed[-1]
