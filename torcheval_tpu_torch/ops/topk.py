"""Top-k selection engine: the CUDA kernel ``csrc/topk.cu``, its plain
version, and the dense and threshold-prune lowerings.

JAX counterpart: ``torcheval_tpu/ops/topk.py`` (``topk``, ``topk_values``,
``topk_indices``, ``_pick_method``, ``prune_topk`` and the Pallas kernel
``_topk_kernel`` behind ``pallas_topk``). The contract is the one that
module documents for ``jax.lax.top_k``: per row, the k largest values in
descending order, ties broken by the lowest index, over the TOTAL order of
float32 (``+NaN > +inf > ... > +0.0 > -0.0 > ... > -inf > -NaN``), with the
values returned bit for bit from the input. ``torch.topk`` promises no tie
order and ``torch.sort`` puts both NaNs first and ties the zeros, so every
lowering here orders an integer key of the float's bits instead
(:func:`order_key`).

Methods (``method=``):

* ``"dense"``: the counterpart of ``jax.lax.top_k``. A stable descending
  sort of the int32 order keys, cut to k, with the values gathered from the
  input. Indices come back int64, as ``torch.topk`` gives them and
  ``torch.gather`` takes them (the JAX side returns int32).
* ``"prune"``: :func:`prune_topk`, the exact threshold-prune lowering with
  its overflow valve, in plain PyTorch.
* ``"kernel"``: the hand-written CUDA kernel, where the JAX package says
  ``"pallas"``. A CUDA tensor launches it (:func:`topk_kernel`); a CPU
  tensor runs its plain version, :func:`topk_kernel_plain`.
* ``"auto"``: :func:`_pick_method`.

Sharded forms, one process per card:

* :func:`sharded_topk_kernel`, the counterpart of ``sharded_pallas_topk``
  (row-sharded): each rank selects over the rows it holds, and the
  outputs stay on its device; no collective runs.
* :func:`sharded_label_topk`, the label-sharded engine: each rank holds
  the label tile of a ``DeviceMesh`` dim, selects its tile's candidates,
  and one ``all_gather`` over the dim's group plus an exact merge give
  every rank of the group the top-k of the whole label axis. A tensor
  carries no sharding, so the mesh is always passed; the JAX engine's
  pick of a label-sharded operand (``label_sharding_of``, ``topk``'s
  auto route to it) has no counterpart.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torcheval_tpu_torch import _build
from torcheval_tpu_torch.obs import registry as _obs
from torcheval_tpu_torch.obs.cost import nbytes
from torcheval_tpu_torch.obs.recompile import count_launch, watched
from torcheval_tpu_torch.utils import dist as _dist
from torcheval_tpu_torch.utils.convert import as_tensor

_METHODS = ("auto", "dense", "prune", "kernel")

# Below this label width the dense sort is cheaper than streaming selection
# (the JAX package's threshold, kept so both packages pick alike).
_DENSE_L_MAX = 1024
# The kernel ranks its last k keys in one block; the JAX kernel's bound of
# one 128-lane carry is kept as the contract.
_KERNEL_MAX_K = 128
# Prune grouping: group width along the label axis and the per-group
# survivor budget.
_PRUNE_GROUP_W = 128
_PRUNE_SURVIVOR_BUDGET = 8


# the signed integer of each float's width, whose order the key maps onto
_BITS = {
    torch.float16: torch.int16,
    torch.bfloat16: torch.int16,
    torch.float32: torch.int32,
    torch.float64: torch.int64,
}


def _flip(b: torch.Tensor) -> torch.Tensor:
    """Keep the bits of a non-negative word and flip all but the sign of a
    negative one. On a float's bits this gives a signed integer whose order
    is the float's total order; the map is its own inverse."""
    width = torch.iinfo(b.dtype).bits
    return b ^ ((b >> (width - 1)) & torch.iinfo(b.dtype).max)


def order_key(x: torch.Tensor) -> torch.Tensor:
    """The integer key of ``x`` whose order is the total order of its float
    type (an integer tensor is its own key)."""
    return _flip(x.view(_BITS[x.dtype])) if x.is_floating_point() else x


def _check(x: torch.Tensor, k: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D (rows, labels), got shape {tuple(x.shape)}.")
    if type(k) is not int:
        raise TypeError(f"Expected `k` to be an integer, but {type(k)} was provided.")
    if not 1 <= k <= x.shape[1]:
        raise ValueError(f"requires 1 <= k <= L, got k={k} at L={x.shape[1]}.")


def _pick_method(l: int, k: int, dtype: torch.dtype, method: str, device: torch.device) -> str:
    """The lowering for an (N, L) top-k (JAX: ``topk.py:179-202``).

    ``auto`` is dense for ``L <= 1024``, ``k >= L``, a non-float32 operand
    or ``k > 128``; otherwise the CUDA kernel on a CUDA tensor, and dense on
    a CPU tensor, as the JAX package is dense on the CPU."""
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}.")
    if method != "auto":
        return method
    if l <= _DENSE_L_MAX or k >= l or dtype != torch.float32 or k > _KERNEL_MAX_K:
        return "dense"
    return "dense" if device.type == "cpu" else "kernel"


def _dense(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` in plain PyTorch: a stable descending sort of the
    order keys (lowest index first among equal keys), values gathered."""
    idx = torch.sort(order_key(x), dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(x, 1, idx), idx


# ------------------------------------------------------------------ kernel
def _kernel_check(x: torch.Tensor, k: int) -> None:
    _check(x, k)
    if x.dtype != torch.float32:
        raise TypeError(f"the top-k kernel takes float32 scores, got {x.dtype}.")
    if k > _KERNEL_MAX_K:
        raise ValueError(
            f"the top-k kernel requires 1 <= k <= min(L, {_KERNEL_MAX_K}), "
            f"got k={k} at L={x.shape[1]}."
        )
    if x.shape[1] >= 2**31 - 1:
        raise ValueError(f"the top-k kernel takes L < 2**31 - 1, got L={x.shape[1]}.")


def topk_kernel_plain(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's radix select in plain PyTorch, over whole rows.

    Each value's 32-bit order key (unsigned, so that its order is the total
    order) is resolved most significant digit first, in the kernel's digits
    of 11, 11 and 10 bits. A step histograms the digit over the keys that
    match the prefix so far, picks the bin where the count from the top
    reaches the number still needed, and marks the keys of the bins above
    it as taken. Once the kth value is known, the ties at it are taken by
    lowest index, as the kernel's inverted-index digits take them. The k
    taken keys are then sorted as the kernel's 64-bit keys (order key high,
    ``2**32 - 1 - index`` low) and decoded."""
    _kernel_check(x, k)
    n, l = x.shape
    dev = x.device
    u = order_key(x).to(torch.int64) + 2**31
    alive = torch.ones((n, l), dtype=torch.bool, device=dev)  # keys matching the prefix
    taken = torch.zeros((n, l), dtype=torch.bool, device=dev)
    need = torch.full((n, 1), k, dtype=torch.int64, device=dev)
    for shift, width in ((21, 11), (10, 11), (0, 10)):
        digit = (u >> shift) & ((1 << width) - 1)
        hist = torch.zeros((n, 1 << width), dtype=torch.int64, device=dev)
        hist.scatter_add_(1, digit, alive.to(torch.int64))
        from_top = hist.flip(1).cumsum(1).flip(1)  # keys in bins >= b
        pick = (from_top >= need).sum(1, keepdim=True) - 1
        need = need - (from_top.gather(1, pick) - hist.gather(1, pick))
        taken |= alive & (digit > pick)
        alive &= digit == pick
    taken |= alive & (alive.cumsum(1) <= need)
    idx = taken.nonzero()[:, 1].reshape(n, k)
    key = (order_key(x).gather(1, idx).to(torch.int64) << 32) | ((2**32 - 1) - idx)
    top = torch.sort(key, dim=1, descending=True).values
    idx = (2**32 - 1) - (top & 0xFFFFFFFF)
    return torch.gather(x, 1, idx), idx


def _topk_cost(args, kwargs, out):
    """The scores read once, the values and indices written once (the
    JAX kernel's int32 indices: ``N * k * 8``); comparisons, no float adds.
    A launch also holds its workspace."""
    x, k = args
    n, l = x.shape
    moved = nbytes(x) + n * k * 8
    work = 0
    if x.device.type != "cpu" and _build.loaded() and n:
        work = max(_build.library().tc_topk_workspace(n, l, k), 1) * 8
    return 0, moved, nbytes(x, *out) + work


@watched(name="topk_kernel", cost=_topk_cost, counts_launches=True)
def topk_kernel(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values (N, k) float32, indices (N, k) int64)`` of float32 scores
    ``x (N, L)``, ``1 <= k <= min(L, 128)``.

    A CPU tensor runs :func:`topk_kernel_plain`. A CUDA tensor launches the
    kernel on PyTorch's current stream, without synchronising, and counts
    the launch (``jit.calls{entry=topk_kernel}``)."""
    _kernel_check(x, k)
    if _build.runs_plain(x):
        return topk_kernel_plain(x, k)
    lib = _build.library()
    x = x.contiguous()
    _build.require_cuda("topk", x)
    n, l = x.shape
    values = torch.empty((n, k), dtype=torch.float32, device=x.device)
    indices = torch.empty((n, k), dtype=torch.int64, device=x.device)
    if n == 0:
        return values, indices
    words = lib.tc_topk_workspace(n, l, k)
    workspace = torch.empty(max(words, 1), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.tc_topk(
            x.data_ptr(),
            n,
            l,
            k,
            workspace.data_ptr(),
            values.data_ptr(),
            indices.data_ptr(),
            _build.stream_of(x),
        )
    _build.check(err, "topk")
    count_launch("topk_kernel", _topk_cost, (x, k), (values, indices))
    return values, indices


# ------------------------------------------------------------------- prune
def _prune_plan(l: int, k: int):
    """(group_w, n_groups, survivor_budget, ok): ``ok`` needs enough groups
    for the kth-group-max threshold (g >= k) and enough candidate room."""
    w = _PRUNE_GROUP_W
    g = -(-l // w)
    s = min(k, _PRUNE_SURVIVOR_BUDGET)
    ok = l > _DENSE_L_MAX and g >= k and g * s >= k
    return w, g, s, ok


@watched(name="prune_topk")
def prune_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by threshold-prune (JAX: ``topk.py:645-702``). The
    kth-largest 128-wide group maximum bounds the kth value from below; each
    group keeps its top ``s = min(k, 8)`` elements at or above it, and one
    dense top-k over the candidates finishes. When any group holds more
    than ``s`` survivors (a candidate of the true top-k may then have been
    cut) the valve re-runs the dense top-k over the whole batch; the check
    reads one flag on the host. Exact against ``jax.lax.top_k`` for
    NaN-free inputs, as in the JAX package."""
    _check(x, k)
    n, l = x.shape
    x = x.to(torch.float32)
    w, g, s, ok = _prune_plan(l, k)
    if not ok:
        return _dense(x, k)
    l_pad = g * w
    xp = torch.nn.functional.pad(x, (0, l_pad - l), value=float("-inf")) if l_pad != l else x
    gmax = xp.reshape(n, g, w).amax(dim=2)
    theta = _dense(gmax, k)[0][:, k - 1 : k]
    mask = xp >= theta
    counts = mask.reshape(n, g, w).sum(dim=2)
    if bool((counts > s).any()):
        return _dense(x, k)
    xm = torch.where(mask, xp, float("-inf")).reshape(n * g, w)
    cand_v, cand_j = _dense(xm, s)
    cand_i = cand_j.reshape(n, g, s) + (
        torch.arange(g, dtype=torch.int64, device=x.device) * w
    )[None, :, None]
    vals, pos = _dense(cand_v.reshape(n, g * s), k)
    return vals, torch.gather(cand_i.reshape(n, g * s), 1, pos)


# ------------------------------------------------------------------ engine
def topk(x: torch.Tensor, k: int, *, method: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the k largest entries per row of ``x``
    ``(rows, labels)``, in ``jax.lax.top_k``'s order; indices are int64.

    Args:
        x: scores ``(rows, labels)``: a tensor (used where it lies) or
            anything ``torch.tensor`` takes (on the CPU).
        k: ``1 <= k <= labels``.
        method: ``"auto"`` (:func:`_pick_method`), or a forced ``"dense"``,
            ``"prune"`` or ``"kernel"``. A forced kernel casts to float32,
            as the JAX package's forced ``"pallas"`` does.
    """
    x = as_tensor(x)
    _check(x, k)
    resolved = _pick_method(x.shape[1], k, x.dtype, method, x.device)
    if _obs._enabled:
        _count_topk(x, k, resolved)
    if resolved == "dense":
        return _dense(x, k)
    if resolved == "prune":
        return prune_topk(x, k)
    return topk_kernel(x.to(torch.float32), k)


def _count_topk(x: torch.Tensor, k: int, resolved: str) -> None:
    """``ops.topk.calls{path=}`` for the route that runs (an infeasible
    prune runs dense; the kernel method on a CPU tensor runs its plain
    version, path ``torch``) and the label-axis bytes it holds."""
    if resolved == "prune" and not _prune_plan(x.shape[1], k)[3]:
        resolved = "dense"
    elif resolved == "kernel":
        resolved = "torch" if _build.runs_plain(x) else "cuda"
    _obs.counter("ops.topk.calls", path=resolved)
    _obs.gauge("ops.topk.label_bytes_per_device", float(x.shape[0] * x.shape[1] * 4), path=resolved)


def topk_values(x: torch.Tensor, k: int, *, method: str = "auto") -> torch.Tensor:
    """The values half of :func:`topk`."""
    return topk(x, k, method=method)[0]


def topk_indices(x: torch.Tensor, k: int, *, method: str = "auto") -> torch.Tensor:
    """The indices half of :func:`topk`."""
    return topk(x, k, method=method)[1]


# ----------------------------------------------------------------- sharded
def sharded_topk_kernel(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sharded top-k: :func:`topk_kernel` over the rows this rank holds
    (its block of the global batch, ``parallel.shard_batch``), the outputs
    on this rank's device; no collective runs. Top-k is row-independent, so
    the ranks' outputs in rank order are the top-k of the global batch.

    JAX counterpart: ``sharded_pallas_topk`` (``topk.py:353-358``), whose
    partitioning rule (``_topk_partition``) runs the kernel on each
    shard's rows and leaves the outputs row-sharded."""
    return topk_kernel(x, k)


# the order key of padding candidates: below every float32 key (the lowest,
# -NaN with every mantissa bit set, is the int32 minimum)
_PAD_KEY = -(2**31) - 1
# companion columns travel as int64 words of their own bits
_WORDS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _local_label_topk(x: torch.Tensor, k: int, method: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's selection over its label tile (JAX: ``topk.py:418-440``):
    ``auto`` is the kernel on a CUDA tensor with ``k <= 128`` and dense
    otherwise (the JAX engine picks by the mesh's platform the same way);
    a forced method runs as in :func:`topk`."""
    if method == "auto":
        method = "kernel" if x.device.type == "cuda" and k <= _KERNEL_MAX_K else "dense"
    return topk(x, k, method=method)


def _to_words(c: torch.Tensor) -> torch.Tensor:
    return c.contiguous().view(_WORDS[c.element_size()]).to(torch.int64)


def _from_words(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return w.to(_WORDS[dtype.itemsize]).view(dtype)


@watched(name="sharded_label_topk")
def sharded_label_topk(
    x: torch.Tensor,
    k: int,
    *,
    mesh,
    label_axis: str,
    method: str = "auto",
    gather=None,
):
    """Top-k over a label axis split over the ranks of a mesh dim: this
    rank's ``(values, indices)`` of the k largest scores per row of the
    WHOLE label axis, in ``jax.lax.top_k``'s order, indices global (int64).

    JAX counterpart: ``sharded_label_topk`` (``topk.py:520-629``, its
    per-shard body ``_sharded_label_program``). Bit for bit the top-k of the
    global matrix, as there. Steps on each rank:

    1. the rank's tile ``x`` (rows, tile width) selects its
       ``min(k, tile width)`` candidates (:func:`_local_label_topk`: the
       kernel on the card), padded to ``k`` with candidates whose key lies
       below every real score, so that every rank sends equal sizes;
    2. the companion column ``gather`` is taken at the local indices;
    3. ONE ``all_gather`` over the dim's process group carries every
       rank's candidates (int64 words: order key, local index, companion)
       and its tile width. It synchronises the group, as the JAX program's
       all_gather does; with gloo it is staged through the host;
    4. each candidate's index becomes global by adding the sum of the
       widths of the tiles before its rank;
    5. the exact merge: one stable descending sort of the ``k * S`` order
       keys (:func:`order_key`, the total order of float32). Candidates sit
       in rank order, each rank's in ascending index among equal keys, so
       ties resolve to the lowest global index; a real ``-inf`` beats
       padding.

    The tiles must be contiguous and in the order of the ranks in the
    dim's group (the block-range split of ``parallel.label_tile``; a
    rank's tile may be empty). Rows
    are the same on every rank of the group. ``k`` may exceed the global
    label count: the columns past it are padding, value ``-inf`` and index
    -1.

    Args:
        x: this rank's score tile ``(rows, tile width)``; selected in
            float32, as the JAX engine selects.
        k: ``k >= 1``.
        mesh, label_axis: a ``DeviceMesh`` and the name of its label dim.
        method: the local lowering (``auto``, ``dense``, ``prune``,
            ``kernel``).
        gather: optional companion tile of ``x``'s shape (a relevance
            tile), returned at the selected indices as a third output.
    """
    x = as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D (rows, labels), got shape {tuple(x.shape)}.")
    if type(k) is not int:
        raise TypeError(f"Expected `k` to be an integer, but {type(k)} was provided.")
    if k < 1:
        raise ValueError(f"requires k >= 1, got k={k}.")
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}.")
    ax = _dist.mesh_axis(mesh, label_axis)
    if gather is not None:
        gather = as_tensor(gather)
        if gather.shape != x.shape:
            raise ValueError(
                f"gather operand must match x's shape {tuple(x.shape)}, got {tuple(gather.shape)}."
            )
    n, w = x.shape
    dev = x.device
    k_local = min(k, w)
    cols = 3 if gather is not None else 2
    words = torch.zeros((n, cols, k), dtype=torch.int64, device=dev)
    words[:, 0] = _PAD_KEY
    if k_local:
        v, i = _local_label_topk(x.to(torch.float32), k_local, method)
        words[:, 0, :k_local] = order_key(v).to(torch.int64)
        words[:, 1, :k_local] = i
        if gather is not None:
            words[:, 2, :k_local] = _to_words(torch.gather(gather, 1, i))
    width = torch.full((1,), w, dtype=torch.int64, device=dev)
    got = _dist.all_gather_stacked(torch.cat([words.reshape(-1), width]), ax.group).to(dev)
    if _obs._enabled:
        _obs.counter("ops.topk.calls", path="sharded_label")
        # the one exchange: every rank's candidate words and tile width
        _obs.counter("ops.topk.merge_bytes", float(got.numel() * got.element_size()))
        _obs.gauge("ops.topk.label_bytes_per_device", float(n * w * 4), path="sharded_label")
    widths = got[:, -1]
    offsets = torch.cumsum(widths, 0) - widths
    # (S, n, cols, k) to (n, cols, S * k): rank-major candidates per row
    cand = got[:, :-1].reshape(ax.size, n, cols, k).permute(1, 2, 0, 3).reshape(n, cols, ax.size * k)
    keys = cand[:, 0]
    glob = cand[:, 1] + offsets.repeat_interleave(k)
    pos = torch.sort(keys, dim=1, descending=True, stable=True).indices[:, :k]
    top = torch.gather(keys, 1, pos)
    pad = top == _PAD_KEY
    values = _flip(top.to(torch.int32)).view(torch.float32).masked_fill(pad, float("-inf"))
    indices = torch.gather(glob, 1, pos).masked_fill(pad, -1)
    if gather is None:
        return values, indices
    comp = _from_words(torch.gather(cand[:, 2], 1, pos), gather.dtype)
    return values, indices, comp.masked_fill(pad, 0)
