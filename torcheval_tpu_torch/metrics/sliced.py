"""``SlicedMetricCollection``: the same metrics across many cohorts.

JAX counterpart: ``torcheval_tpu/metrics/sliced.py``.

* **Dense slice axis.** Every member's state grows a leading
  ``[capacity]`` axis: ``state[r]`` is slice ``r``'s state, with exactly the
  template metric's shape past axis 0.
* **Sparse ids to dense rows.** Cohort ids are arbitrary int64s. A
  :class:`SliceTable` interns them on the host in first-seen order (a
  vectorised ``searchsorted``, no per-sample Python); the device sees dense
  int32 rows only. Capacity grows geometrically by padding with the state's
  default: rows never move.
* **Generic member fold.** A member expands a template metric whose fold is
  per-sample decomposable (``metrics/deferred.py``): the template's own
  ``_fold_fn`` runs per sample under ``torch.func.vmap`` (batch-of-one
  calls, so the math is the standalone metric's), and the per-sample deltas
  go through ONE ``ops/scatter.py::segment_scatter`` per group of deltas of
  the same shape and type. A ``sum`` group is the segment-sum kernel
  (``csrc/scatter.cu``) on the card, so per-slice counts equal the
  standalone metric's on each slice's samples; ``max``/``min`` groups are
  ``scatter_reduce_``. Compute runs the template's ``_compute_fn`` under
  ``torch.func.vmap`` over the slice axis.
* **Sketch member.** An ``approx=`` binary curve template (``BinaryAUROC``,
  ``BinaryAUPRC``) expands into per-cohort ``(B,)`` score sketches
  (``_SlicedScoreSketchMember``): one segment sum of int32 ones by
  ``row * (2B + 1) + plane`` folds a window into every cohort's ``(tp,
  fp)`` histogram and NaN count, and the compute is the standalone
  sketch's presorted counts function along the last axis, so a cohort's
  value equals the standalone ``approx=`` metric's on that cohort's rows.
  ``curve_bucket_bits`` may set a coarser width than the standalone floor
  (down to 4 bits); the int32 combined index is checked at registration
  and at every capacity growth (``sketch.cache.check_sliced_sketch_extent``).
* **Ids on the wire.** Each member carries the id table as
  ``slice_ids_hi``/``slice_ids_lo`` int32 lanes and a ``slice_count``
  scalar, refreshed from the host table when state is read, so
  ``state_dict()`` round-trips the table and :func:`align_sliced_gathered`
  can merge ragged replicas by id after a gather.

Results come back keyed by the original ids: ``compute()`` returns
``{member: SlicedResult}``, a plain dict ``{"slice_ids": int64 ids,
"values": per-slice values}``, values aligned 1:1 with the ids.

The id column stays on the host (interning needs its bytes), and each
batch's interned rows are copied to the members' device.

**Sharded slice axis.** ``mesh=`` (a ``DeviceMesh``) with ``mesh_axis=``
(one of its dim names) splits the slice axis of every member state over
that dim's ``S`` ranks, one process per card: rank ``r`` holds the tile of
rows ``[r*w, (r+1)*w)``, ``w = capacity / S``, and the capacity stays a
multiple of ``S``. Every rank receives the same batches (ids and columns)
and interns them the same way, so the :class:`SliceTable` and the id lanes
are the same on every rank and no id crosses the wire. A fold runs no
collective: each rank reduces the batch into its own tile
(``ops/scatter.py``'s block-range route; the sketch member builds its
combined index over its tile, so its int32 bound is per shard).
Collectives over the dim's group, which every rank of it runs together:
``compute()`` computes each rank's cohorts and gathers the per-cohort
values (never the states); ``state_dict()`` gathers the tiles into the
unsharded layout, so a state dict loads into a collection sharded any way
or not at all, and into the JAX package's (``utils/jax_state.py``);
``load_state_dict`` keeps this rank's tile; a capacity growth and a merge
gather the tiles they re-cut. Results equal the unsharded collection's
(integer lanes exactly; float sums within ``ops/scatter.py``'s bound).
A sharded member or collection pickles as unsharded, holding the global
value (the JAX package's degradation: its mesh holds process groups), so
pickling it gathers the tiles, a collective over the slice dim as
``state_dict()`` is; ``copy.deepcopy`` shares the mesh and keeps the tiles.
A sync over the data ranks (the toolkit's ``processes=``) gathers each
replica's unsharded layout and keeps this rank's tiles of the fold.

**Windows.** The members ride the collection's window
(``metrics/deferred.py``) as concat-fold members (``_fold_per_chunk =
False``): ``update()`` appends ``(rows, *columns)`` to the window once, and
the window's fold concatenates its batches and runs one segment scatter per
group of deltas, so a ``sum`` group is one segment-sum launch per window. A
capacity growth does not fold the window, as in the JAX package: rows never
move, the states are padded out of place, and the fold reads the capacity
when it runs. On the CPU a window of bfloat16 or float16 deltas adds in the
half type in sample order, so the sliced ``Sum``/``Mean`` equal the JAX
package's under the same windows exactly; on the card the segment-sum
kernel adds in float32 and rounds once (``ops/scatter.py``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.metrics.classification.auroc import _CurveMetric, _MulticlassCurveMetric
from torcheval_tpu_torch.metrics.collection import MetricCollection
from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction
from torcheval_tpu_torch.ops.scatter import segment_scatter
from torcheval_tpu_torch.sketch.cache import (
    check_sliced_bucket_bits,
    check_sliced_sketch_extent,
    raise_sketch_nan,
    raise_sketch_overflow,
    sliced_curve_compute,
    sliced_score_hist_fold,
)
from torcheval_tpu_torch.utils import dist as _dist
from torcheval_tpu_torch.utils.devices import DeviceLike
from torcheval_tpu_torch.utils.dist import MeshAxis

__all__ = [
    "SliceTable",
    "SlicedResult",
    "SlicedMetricCollection",
    "check_sliceable",
    "align_sliced_gathered",
]

_DEFAULT_CAPACITY = 1024

_LO_MASK = np.int64(0xFFFFFFFF)


def _pack_ids(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64 ids as int32 ``(hi, lo)`` halves. The ``lo`` mask keeps
    negative ids exact through the round trip with :func:`_unpack_ids`."""
    ids = np.asarray(ids, np.int64)
    return (ids >> 32).astype(np.int32), (ids & _LO_MASK).astype(np.int32)


def _unpack_ids(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (np.asarray(hi).astype(np.int64) << 32) | (np.asarray(lo).astype(np.int64) & _LO_MASK)


def _to_numpy(v: Any) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _tree_map(fn, tree):
    """``fn`` on every leaf of nested tuples, lists and dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


# ---------------------------------------------------------------- id table
class SliceTable:
    """Append-only intern table: original int64 slice ids to dense rows.

    Rows are assigned in first-seen order and never move (growth is a pure
    capacity pad), so state grows by padding and a table round-trips
    exactly through a state dict. Lookup is ``np.searchsorted`` over a
    sorted shadow index, rebuilt only on batches that registered new ids.
    """

    __slots__ = (
        "ids",
        "count",
        "capacity",
        "granularity",
        "version",
        "_sorted_ids",
        "_sorted_rows",
    )

    def __init__(self, capacity: int = _DEFAULT_CAPACITY, *, granularity: int = 1) -> None:
        if not isinstance(capacity, int) or capacity < 1:
            raise ValueError(f"capacity must be an int >= 1, got {capacity!r}.")
        # the capacity stays a multiple of the granularity through every
        # growth: a sharded slice axis splits into equal tiles
        self.granularity = max(int(granularity), 1)
        self.capacity = self.round_capacity(capacity)
        self.count = 0
        self.ids = np.zeros(self.capacity, np.int64)
        self.version = 0  # bumped on every mutation: the id lanes' refresh key
        self._sorted_ids = np.empty(0, np.int64)
        self._sorted_rows = np.empty(0, np.int64)

    def round_capacity(self, capacity: int) -> int:
        """``capacity`` rounded up to a multiple of the granularity."""
        g = self.granularity
        return -(-int(capacity) // g) * g

    def predict_growth(self, need: int) -> int:
        """The capacity :meth:`intern` settles on for ``need`` rows: the one
        definition of the growth schedule (doubling, then the granularity's
        round-up)."""
        cap = max(self.capacity, 1)
        while cap < int(need):
            cap *= 2
        return self.round_capacity(cap)

    def _rebuild_index(self) -> None:
        order = np.argsort(self.ids[: self.count], kind="stable")
        self._sorted_ids = self.ids[: self.count][order]
        self._sorted_rows = order

    def _lookup(self, batch: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``(rows, found)`` for ``batch``; rows are garbage where not found."""
        if self.count == 0:
            return np.zeros(batch.shape, np.int64), np.zeros(batch.shape, bool)
        pos = np.searchsorted(self._sorted_ids, batch)
        clip = np.minimum(pos, self._sorted_ids.shape[0] - 1)
        found = self._sorted_ids[clip] == batch
        return self._sorted_rows[clip], found

    def intern(self, slice_ids: Any) -> Tuple[np.ndarray, bool]:
        """Dense int32 rows for a batch's id column, registering unseen ids
        in first-seen order. ``grew`` means the capacity changed and every
        member's state must pad to :attr:`capacity` before the rows are
        used."""
        batch = np.asarray(slice_ids)
        if batch.ndim != 1 or batch.dtype.kind not in "iu":
            raise ValueError(
                "slice_ids must be a 1-D integer column, got "
                f"shape {batch.shape} dtype {batch.dtype}."
            )
        batch = batch.astype(np.int64, copy=False)
        rows, found = self._lookup(batch)
        grew = False
        if not found.all():
            uniq, first = np.unique(batch[~found], return_index=True)
            fresh = uniq[np.argsort(first)]  # first-seen order
            need = self.count + fresh.shape[0]
            if need > self.capacity:
                new_cap = self.predict_growth(need)
                grown = np.zeros(new_cap, np.int64)
                grown[: self.count] = self.ids[: self.count]
                self.ids = grown
                self.capacity = new_cap
                grew = True
            self.ids[self.count : need] = fresh
            self.count = need
            self._rebuild_index()
            self.version += 1
            rows, found = self._lookup(batch)
        return rows.astype(np.int32), grew

    def mark(self) -> Tuple[int, int, np.ndarray]:
        """Rollback point: growth allocates a fresh ids array, so holding the
        old one restores exactly."""
        return (self.count, self.capacity, self.ids)

    def rollback(self, mark: Tuple[int, int, np.ndarray]) -> None:
        """Undo registrations and growth since ``mark``, for a growth the
        members rejected: a table grown past its members would scatter new
        cohorts out of the members' segment range."""
        self.count, self.capacity, self.ids = mark
        self._rebuild_index()
        self.version += 1

    def lookup_rows(self, slice_ids: np.ndarray) -> np.ndarray:
        """Rows for ids that must already be registered."""
        batch = np.asarray(slice_ids).astype(np.int64, copy=False)
        rows, found = self._lookup(batch)
        if not found.all():
            raise KeyError("lookup_rows() called with unregistered slice ids.")
        return rows.astype(np.int32)

    def registered_ids(self) -> np.ndarray:
        return self.ids[: self.count].copy()

    def replace(self, ids: np.ndarray, capacity: int) -> None:
        """Install a table wholesale (a loaded state dict). Idempotent, so
        every member of a collection may install the same table."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if capacity < ids.shape[0]:
            raise ValueError(f"capacity {capacity} < registered id count {ids.shape[0]}.")
        if np.unique(ids).shape[0] != ids.shape[0]:
            raise ValueError("slice id table contains duplicate ids.")
        self.capacity = int(capacity)
        self.count = int(ids.shape[0])
        self.ids = np.zeros(self.capacity, np.int64)
        self.ids[: self.count] = ids
        self._rebuild_index()
        self.version += 1

    def clear(self) -> None:
        self.count = 0
        self._sorted_ids = np.empty(0, np.int64)
        self._sorted_rows = np.empty(0, np.int64)
        self.version += 1


# ----------------------------------------------------------------- results
class SlicedResult(dict):
    """Per-slice compute result keyed by original slice ids: a plain dict
    ``{"slice_ids": np.int64[R], "values": tree of per-slice leaves}``. The
    accessors do not shadow the dict protocol (``.values()`` stays the dict
    method; the per-slice leaves are ``res["values"]`` or
    :attr:`slice_values`). Leaves carry the slice axis first."""

    def __init__(self, slice_ids: np.ndarray, values: Any) -> None:
        super().__init__(slice_ids=np.asarray(slice_ids, np.int64), values=values)

    @property
    def slice_ids(self) -> np.ndarray:
        return self["slice_ids"]

    @property
    def slice_values(self) -> Any:
        return self["values"]

    @property
    def num_slices(self) -> int:
        return int(self["slice_ids"].shape[0])

    def value_of(self, slice_id: int) -> Any:
        idx = np.nonzero(self["slice_ids"] == int(slice_id))[0]
        if idx.size == 0:
            raise KeyError(f"slice id {slice_id!r} was never observed.")
        i = int(idx[0])
        return _tree_map(lambda v: v[i], self["values"])

    def as_dict(self) -> Dict[int, Any]:
        """``{slice id: value}`` with numpy leaves (each leaf indexed on its
        own slice axis, so tuple-valued results stay tuples)."""
        vals = _tree_map(_to_numpy, self["values"])
        return {
            int(i): _tree_map(lambda v: v[n], vals) for n, i in enumerate(self["slice_ids"])
        }


# ----------------------------------------------------------- generic folds
_REDUCE_KINDS = {None: "sum", torch.maximum: "max", torch.minimum: "min"}
_REDUCTION_KINDS = {Reduction.SUM: "sum", Reduction.MAX: "max", Reduction.MIN: "min"}


def _sliced_fold(*xs):
    """The fold of every generic member: the template's ``_fold_fn`` per
    sample under ``torch.func.vmap``, then one segment scatter into the
    slice axis for each group of deltas with the same trailing shape and
    type (a counter pair folds in one (N, 2) scatter). Trailing statics:
    ``(base_fn, base_params, num_slices, reduce_kind, shard)``, ``shard``
    the slice axis's ``MeshAxis`` or None (then each scatter gives this
    rank's tile); leading operands: ``(rows, *update_columns)``."""
    base_fn, base_params, num_slices, reduce_kind, shard = xs[-5:]
    rows = xs[0]
    cols = xs[1:-5]
    mesh_kw = {} if shard is None else {"mesh": shard.mesh, "axis": shard.name}
    per_sample = torch.func.vmap(lambda *a: base_fn(*(c[None] for c in a), *base_params))(*cols)
    groups: Dict[Any, List[str]] = {}
    for name, delta in per_sample.items():
        groups.setdefault((tuple(delta.shape[1:]), delta.dtype), []).append(name)
    out = {}
    for names in groups.values():
        if len(names) == 1:
            out[names[0]] = segment_scatter(
                per_sample[names[0]], rows, num_slices, reduce=reduce_kind, **mesh_kw
            )
            continue
        stacked = torch.stack([per_sample[n] for n in names], dim=-1)
        folded = segment_scatter(stacked, rows, num_slices, reduce=reduce_kind, **mesh_kw)
        for i, name in enumerate(names):
            out[name] = folded[..., i]
    return out


def _sliced_compute(*xs):
    """The compute of every generic member: the template's ``_compute_fn``
    under ``torch.func.vmap`` over the slice axis. Trailing statics:
    ``(base_fn, base_params, n_template_states)``; the id lanes follow the
    template states and are cut off here."""
    base_fn, base_params, n_states = xs[-3:]
    return torch.func.vmap(lambda *s: base_fn(*s, *base_params))(*xs[:n_states])


# ------------------------------------------------------------ member shell
_ID_STATE_NAMES = ("slice_ids_hi", "slice_ids_lo", "slice_count")


class _SlicedMemberBase(DeferredFoldMixin, Metric):
    """One template metric expanded over the slice axis.

    States: the template's, same names, types and reductions, shape
    ``(capacity, *S)`` (with ``shard``, this rank's ``(capacity / S, *S)``
    tile); ``slice_ids_hi``/``slice_ids_lo`` int32 ``(capacity,)`` (the
    int64 id table in two halves) and the ``slice_count`` int32 scalar. The
    authoritative table is the host-side :class:`SliceTable` shared by
    every member of one collection; the id lanes are refreshed from it when
    state is read.
    """

    _fold_per_chunk = False  # concat: one segment scatter per window
    # the toolkit's sync aligns gathered replicas by id before folding
    # (align_sliced_gathered) and adopts the union table afterwards
    _sliced_sync = True

    def __init__(
        self, table: SliceTable, device: DeviceLike = None, shard: Optional[MeshAxis] = None
    ) -> None:
        super().__init__(device=device)
        self._init_deferred()
        self._table = table
        self._shard = shard
        self._shards = shard.size if shard is not None else 1
        self._table_version = -1
        self._row_defaults: Dict[str, torch.Tensor] = {}
        self._sliced_state_names: Tuple[str, ...] = ()

    # ------------------------------------------------------------ the tiles
    def _tile_rows(self, capacity: int) -> int:
        """Rows of each sliced state this rank holds at ``capacity``."""
        return capacity // self._shards

    def _tile_of(self, full: torch.Tensor, capacity: int) -> torch.Tensor:
        """This rank's tile of a sliced state in the unsharded layout."""
        w = self._tile_rows(capacity)
        start = self._shard.rank * w if self._shard is not None else 0
        return full[start : start + w]

    def _gather_rows(self, tile: torch.Tensor) -> torch.Tensor:
        """The unsharded layout of a per-rank tile (a sliced state, or a
        compute's per-cohort values): one all_gather over the slice group,
        on ``tile``'s device. Identity when unsharded."""
        if self._shard is None:
            return tile
        got = _dist.all_gather_stacked(tile, self._shard.group).to(tile.device)
        return got.reshape((-1,) + tuple(tile.shape[1:]))

    def _mesh_kw(self) -> Dict[str, Any]:
        return {} if self._shard is None else {"mesh": self._shard.mesh, "axis": self._shard.name}

    # -------------------------------------------------------- registration
    def _register_sliced_state(
        self, name: str, row_default: torch.Tensor, reduction: Reduction
    ) -> None:
        row_default = torch.as_tensor(row_default).cpu()
        rows = self._tile_rows(self._table.capacity)
        default = row_default.expand((rows,) + row_default.shape).clone()
        self._add_state(name, default, reduction=reduction)
        self._row_defaults[name] = row_default
        self._sliced_state_names = self._sliced_state_names + (name,)

    def _register_id_states(self) -> None:
        cap = self._table.capacity
        self._add_state("slice_ids_hi", torch.zeros(cap, dtype=torch.int32), reduction=Reduction.NONE)
        self._add_state("slice_ids_lo", torch.zeros(cap, dtype=torch.int32), reduction=Reduction.NONE)
        self._add_state("slice_count", torch.zeros((), dtype=torch.int32), reduction=Reduction.NONE)
        # the checkpoint restore's contract (resilience/snapshot.py): these
        # states' leading dim is the capacity, which differs between a fresh
        # member and a grown checkpoint; their trailing dims must match
        self._lead_resizable_states = frozenset(
            self._sliced_state_names + ("slice_ids_hi", "slice_ids_lo")
        )

    # ------------------------------------------------------------- re-size
    def _refit_params(self) -> None:
        """Rebuild ``_fold_params``/``_compute_params`` after the capacity
        changed (the fold's statics carry ``num_slices``)."""
        raise NotImplementedError

    def _check_capacity(self, capacity: int) -> None:
        """Raise if this member cannot hold ``capacity`` rows; run for every
        member before any member's state pads, so a failed growth never
        leaves the collection half grown. Generic members have no bound."""

    def _set_default(self, name: str, row_default: torch.Tensor, rows: int) -> None:
        self._state_name_to_default[name] = row_default.expand((rows,) + row_default.shape).clone()

    def _grow_to(self, capacity: int) -> None:
        """Pad every sliced state and id lane to ``capacity`` rows with its
        default (rows never move: interning is append-only). A sharded
        state's tiles change width, so it is gathered, padded and cut again
        (growth doubles, so this is rare)."""
        for name in self._sliced_state_names + ("slice_ids_hi", "slice_ids_lo"):
            sliced = name in self._sliced_state_names
            rows = self._tile_rows(capacity) if sliced else capacity
            cur = getattr(self, name)
            if cur.shape[0] >= rows:
                continue
            row_default = self._row_defaults.get(name, torch.zeros((), dtype=torch.int32))
            full = self._gather_rows(cur) if sliced else cur
            fill = row_default.to(full.device, full.dtype).expand(
                (capacity - full.shape[0],) + row_default.shape
            )
            grown = torch.cat([full, fill])
            setattr(self, name, self._tile_of(grown, capacity).clone() if sliced else grown)
            self._set_default(name, row_default, rows)
        self._refit_params()

    # ------------------------------------------------------- id-lane sync
    def _refresh_id_states(self) -> None:
        """Mirror the host table into the id lanes, when it changed."""
        t = self._table
        if self._table_version == t.version and self.slice_ids_hi.shape[0] == t.capacity:
            return
        ids = np.zeros(t.capacity, np.int64)
        ids[: t.count] = t.ids[: t.count]
        hi, lo = _pack_ids(ids)
        self.slice_ids_hi = torch.from_numpy(hi).to(self._device)
        self.slice_ids_lo = torch.from_numpy(lo).to(self._device)
        self.slice_count = torch.tensor(t.count, dtype=torch.int32).to(self._device)
        self._table_version = t.version

    def _adopt_state_shapes(self) -> None:
        """Rebuild the host table and the capacity from the id lanes: the
        direction of a loaded state dict, where the states are
        authoritative. Idempotent across the members of one collection."""
        hi = _to_numpy(self.slice_ids_hi)
        lo = _to_numpy(self.slice_ids_lo)
        count = int(_to_numpy(self.slice_count))
        capacity = int(hi.shape[0])
        rows = self._tile_rows(capacity)
        for name in self._sliced_state_names:
            if getattr(self, name).shape[0] != rows or rows * self._shards != capacity:
                raise ValueError(
                    f"state {name!r} has {getattr(self, name).shape[0]} rows but the id "
                    f"lanes hold {capacity} over {self._shards} shard(s)."
                )
        self._table.replace(_unpack_ids(hi, lo)[:count], capacity)
        for name in self._sliced_state_names:
            self._set_default(name, self._row_defaults[name], rows)
        for name in ("slice_ids_hi", "slice_ids_lo"):
            self._state_name_to_default[name] = torch.zeros(capacity, dtype=torch.int32)
        self._table_version = self._table.version
        self._refit_params()

    # ----------------------------------------------------- protocol plumbing
    def state_dict(self):
        """The state in the unsharded layout (a sharded member gathers its
        tiles: a collective over the slice group)."""
        self._refresh_id_states()
        out = super().state_dict()
        if self._shard is not None:
            for name in self._sliced_state_names:
                out[name] = self._gather_rows(out[name])
        return out

    def _tiles_of(self, state_dict: Dict[str, Any]) -> Dict[str, Any]:
        """A state dict in the unsharded layout cut to this rank's tiles,
        its capacity first padded up to a multiple of the shard count (with
        each state's default; a checkpoint of any capacity loads)."""
        sd = dict(state_dict)
        hi = sd.get("slice_ids_hi")
        capacity = int(hi.shape[0]) if hi is not None else self._table.capacity
        padded = self._table.round_capacity(capacity)
        for name in ("slice_ids_hi", "slice_ids_lo") + self._sliced_state_names:
            if name not in sd:
                continue
            v = torch.as_tensor(sd[name])
            if padded != capacity:
                default = self._row_defaults.get(name, torch.zeros((), dtype=v.dtype))
                fill = default.to(v.device, v.dtype).expand((padded - capacity,) + tuple(v.shape[1:]))
                v = torch.cat([v, fill])
            sd[name] = self._tile_of(v, padded) if name in self._sliced_state_names else v
        return sd

    def _prepare_for_merge_state(self) -> None:
        super()._prepare_for_merge_state()
        self._refresh_id_states()

    def __getstate__(self) -> Dict[str, Any]:
        """A pickle holds the global value in the unsharded layout and no
        mesh (process groups do not pickle), as the JAX package degrades a
        sharded member. A sharded member gathers its tiles for it, as
        ``state_dict()`` does: a collective over the slice group, which
        every rank of it runs together."""
        self._refresh_id_states()
        state = super().__getstate__()
        if self._shard is not None:
            for name in self._sliced_state_names:
                state[name] = self._gather_rows(state[name])
            state.update(_shard=None, _shards=1)
            state.pop("_fold_params")
            state.pop("_compute_params")
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        degraded = "_fold_params" not in state
        super().__setstate__(state)
        if degraded:
            # pickled from a sharded member: rebuild the unsharded statics
            self._table.granularity = 1
            self._adopt_state_shapes()

    def __deepcopy__(self, memo: Dict[int, Any]) -> "_SlicedMemberBase":
        # a copy shares the mesh and keeps its tiles: no collective
        new = object.__new__(type(self))
        memo[id(self)] = new
        new.__setstate__(copy.deepcopy(DeferredFoldMixin.__getstate__(self), memo))
        return new

    def load_state_dict(self, state_dict, strict: bool = True) -> None:
        # a partial load (strict=False) keeps the current id lanes: bring
        # them up to date with the table first
        self._refresh_id_states()
        if self._shard is not None:
            state_dict = self._tiles_of(state_dict)
        super().load_state_dict(state_dict, strict)
        self._adopt_state_shapes()

    def update(self, rows, *args):
        """``rows`` is the dense int32 row column the owning collection
        interned (raw cohort ids here would alias rows)."""
        self._defer(self._input(rows), *(self._input(a) for a in args))
        return self

    def reset(self):
        out = super().reset()
        self._table_version = -1  # the id lanes were reset to zeros
        return out

    def compute(self):
        return self._deferred_compute()

    def _wrap_values(self, values: Any) -> SlicedResult:
        """Per-cohort values keyed by id; a sharded member's per-tile values
        are gathered first (a collective over the slice group)."""
        count = self._table.count
        return SlicedResult(
            self._table.registered_ids(),
            _tree_map(lambda v: self._gather_rows(v)[:count], values),
        )

    def merge_state(self, metrics):
        """Merge other sliced replicas by original id: unseen ids append to
        the table (growing the capacity as needed), then the other's rows
        combine into this member's rows through ``segment_scatter`` with
        each state's declared reduction. Equal to having streamed the
        other's batches here (integer adds and extrema exactly). A sharded
        source is gathered to the unsharded layout (a collective over its
        slice group), and a sharded member combines into its own tile."""
        for other in self._fold_for_merge(metrics):
            o_count = other._table.count
            if o_count == 0:
                continue
            mark = self._table.mark()
            rows_np, grew = self._table.intern(other._table.registered_ids())
            if grew or self._table.capacity > getattr(self, self._sliced_state_names[0]).shape[0]:
                try:
                    self._check_capacity(self._table.capacity)
                except BaseException:
                    self._table.rollback(mark)
                    raise
                self._grow_to(self._table.capacity)
            rows = torch.from_numpy(rows_np).to(self._device)
            cap = self._table.capacity
            for name in self._sliced_state_names:
                kind = _REDUCTION_KINDS[self._state_name_to_reduction[name]]
                theirs = other._gather_rows(getattr(other, name))[:o_count].to(self._device)
                folded = segment_scatter(theirs, rows, cap, reduce=kind, **self._mesh_kw())
                mine = getattr(self, name)
                if kind == "sum":
                    merged = mine + folded
                elif kind == "max":
                    merged = torch.maximum(mine, folded)
                else:
                    merged = torch.minimum(mine, folded)
                setattr(self, name, merged)
        return self


class _SlicedFoldMember(_SlicedMemberBase):
    """Generic slice expansion of one per-sample-decomposable template
    (accuracy family, MSE, Sum, Mean, Max, Min)."""

    _fold_fn = staticmethod(_sliced_fold)
    _compute_fn = staticmethod(_sliced_compute)

    def __init__(self, template: Metric, table: SliceTable, shard: Optional[MeshAxis] = None) -> None:
        super().__init__(table, device=template.device, shard=shard)
        tcls = type(template)
        self._template_cls = tcls.__qualname__
        self._base_fold = tcls._fold_fn
        self._base_fold_params = tuple(template._fold_params)
        self._base_compute = tcls._compute_fn
        self._base_compute_params = tuple(template._compute_params)
        self._reduce_kind = _REDUCE_KINDS[tcls._fold_reduce]
        self._template_update_check = template._update_check
        for name, red in template._state_name_to_reduction.items():
            self._register_sliced_state(name, template._state_name_to_default[name], red)
        self._register_id_states()
        self._refit_params()

    def _refit_params(self) -> None:
        self._fold_params = (
            self._base_fold,
            self._base_fold_params,
            self._table.capacity,
            self._reduce_kind,
            self._shard,
        )
        self._compute_params = (
            self._base_compute,
            self._base_compute_params,
            len(self._sliced_state_names),
        )

    @property
    def _sync_schema_extra(self) -> Tuple:
        # the JAX package's tuple, so that a checkpoint's schema digest
        # matches across the packages: replicas of another template or
        # configuration cannot add rows; the capacity is not in it (ragged
        # per-rank cohort populations still match: alignment follows the
        # gather)
        return ("sliced", self._template_cls) + self._base_fold_params

    def _update_check(self, rows, *args) -> None:
        _check_rows_column(rows, args)
        check = self._template_update_check
        if check is not None:
            check(*args)

    def _on_window_result(self, result):
        return self._wrap_values(result)


# ``_fold_reduce`` is read from the class, so each reduce has its own class
class _SlicedFoldMemberSum(_SlicedFoldMember):
    _fold_reduce = None


class _SlicedFoldMemberMax(_SlicedFoldMember):
    _fold_reduce = staticmethod(torch.maximum)


class _SlicedFoldMemberMin(_SlicedFoldMember):
    _fold_reduce = staticmethod(torch.minimum)


_FOLD_MEMBER_BY_KIND = {
    "sum": _SlicedFoldMemberSum,
    "max": _SlicedFoldMemberMax,
    "min": _SlicedFoldMemberMin,
}


class _SlicedScoreSketchMember(_SlicedMemberBase):
    """Slice expansion of an ``approx=`` binary curve metric (``BinaryAUROC``
    or ``BinaryAUPRC``): per-cohort ``(B,)`` bucket histograms folded by one
    combined-index segment sum, computed by the standalone sketch's
    presorted counts function along the last axis. A cohort's value equals
    the standalone ``approx=`` metric's fed that cohort's rows (the same
    counts, the same function)."""

    _fold_fn = staticmethod(sliced_score_hist_fold)
    _compute_fn = staticmethod(sliced_curve_compute)

    def __init__(
        self,
        template: Metric,
        table: SliceTable,
        *,
        curve_bucket_bits: Optional[int] = None,
        shard: Optional[MeshAxis] = None,
    ) -> None:
        super().__init__(table, device=template.device, shard=shard)
        self._template_cls = type(template).__qualname__
        self._kind = "auroc" if "AUROC" in self._template_cls else "auprc"
        bits = curve_bucket_bits if curve_bucket_bits is not None else template._sketch_bits
        self._bits = check_sliced_bucket_bits(int(bits))
        # the extent check runs before any state exists: a capacity and width
        # past the int32 index bound must not first allocate the histograms
        self._check_capacity(table.capacity)
        zero_hist = torch.zeros(1 << self._bits, dtype=torch.int32)
        self._register_sliced_state("sketch_tp", zero_hist, Reduction.SUM)
        self._register_sliced_state("sketch_fp", zero_hist, Reduction.SUM)
        self._register_sliced_state(
            "sketch_nan_dropped", torch.zeros((), dtype=torch.int32), Reduction.SUM
        )
        self._register_id_states()
        self._refit_params()

    def _check_capacity(self, capacity: int) -> None:
        # per shard: each rank's combined index runs over its own tile
        check_sliced_sketch_extent(self._bits, capacity, shards=self._shards)

    def _refit_params(self) -> None:
        # runs at construction, at every growth and at every adopted load:
        # the bound holds for the member's life
        self._check_capacity(self._table.capacity)
        self._fold_params = (self._bits, self._table.capacity, self._shard)
        self._compute_params = (self._bits, self._kind)

    @property
    def _sync_schema_extra(self) -> Tuple:
        # the JAX package's tuple: replicas with another template or width
        # cannot add their buckets; the capacity is not in it
        return ("sliced", self._template_cls, self._bits)

    def _update_check(self, rows, *args) -> None:
        _check_rows_column(rows, args)
        if len(args) != 2:
            raise ValueError(
                "sliced curve metrics take (slice_ids, scores, targets), "
                f"got {len(args)} update columns after the id column."
            )
        if args[0].shape != args[1].shape or args[0].ndim != 1:
            raise ValueError(
                "scores and targets must be matching 1-D columns, got "
                f"{tuple(args[0].shape)} vs {tuple(args[1].shape)}."
            )

    def _on_window_result(self, result):
        values, overflow, nan_total = result
        if self._shard is not None:
            # every rank's tile flags, one all_reduce: each rank raises alike
            flags = torch.stack([overflow.to(torch.int64), nan_total.to(torch.int64)])
            flags = _dist.all_reduce_sum(flags, self._shard.group)
            overflow, nan_total = flags[0] > 0, flags[1]
        raise_sketch_overflow(overflow)
        raise_sketch_nan(nan_total, "sample(s)")
        return self._wrap_values(values)


def _check_rows_column(rows: torch.Tensor, args) -> None:
    if rows.ndim != 1 or rows.dtype != torch.int32:
        raise ValueError(
            "the slice row column must be 1-D int32 (the collection interns ids "
            f"before members see them), got shape {tuple(rows.shape)} dtype {rows.dtype}."
        )
    for a in args:
        if getattr(a, "ndim", 0) >= 1 and a.shape[0] != rows.shape[0]:
            raise ValueError(
                "every update column must match the slice column's sample "
                f"count {rows.shape[0]}, got {tuple(a.shape)}."
            )


# ------------------------------------------------------------- sliceability
def check_sliceable(metric: Metric, *, approx: Any = None) -> None:
    """Raise ``ValueError`` when ``metric`` cannot expand over a slice axis.

    Sliceable: (a) a fresh ``DeferredFoldMixin`` metric whose fold runs
    under ``torch.func.vmap`` (``_fold_vmap``), with a known reduce, a pure
    ``_compute_fn`` and tensor states reduced by SUM, MAX or MIN; (b) a
    fresh binary ``approx=`` curve metric (``BinaryAUROC``, ``BinaryAUPRC``),
    or an exact one that ``approx`` (when given) will switch. Exact curves
    and multiclass sketches reject with the JAX package's reasons."""
    cls = type(metric)
    if isinstance(metric, _CurveMetric):
        if isinstance(metric, _MulticlassCurveMetric):
            raise ValueError(
                f"{cls.__qualname__} cannot be sliced: per-slice multiclass sketch "
                "state would be (slices, classes, buckets); slice the binary "
                "one-vs-all projections instead."
            )
        will_be_approx = metric._sketch_enabled() or (approx is not None and approx is not False)
        if not will_be_approx:
            raise ValueError(
                f"{cls.__qualname__} must run approx= to be sliced: a per-slice exact "
                "sample cache is O(samples) per slice and cannot survive the slice "
                "explosion."
            )
        if metric.inputs:
            raise ValueError(
                "cannot slice a curve metric that already holds streamed "
                "samples; construct it fresh."
            )
        return
    if not isinstance(metric, DeferredFoldMixin):
        raise ValueError(
            f"{cls.__qualname__} cannot be sliced: only array-state metrics with a "
            "pure fold expand over a slice axis."
        )
    if cls._compute_fn is None:
        raise ValueError(
            f"{cls.__qualname__} cannot be sliced: its compute has host-side "
            "behavior (no pure _compute_fn to vmap per slice)."
        )
    if not cls._fold_vmap:
        raise ValueError(
            f"{cls.__qualname__} cannot be sliced: its fold kernel has no vmap "
            "batching rule."
        )
    if cls._fold_reduce not in _REDUCE_KINDS:
        raise ValueError(
            f"{cls.__qualname__} cannot be sliced: its _fold_reduce has no known "
            "per-slice segment op."
        )
    metric._fold_now()  # a pending batch makes the metric a used one
    for name, default in metric._state_name_to_default.items():
        if not isinstance(default, torch.Tensor):
            raise ValueError(
                f"{cls.__qualname__} cannot be sliced: state {name!r} is not a plain tensor."
            )
        red = metric._state_name_to_reduction[name]
        if red not in _REDUCTION_KINDS:
            raise ValueError(
                f"{cls.__qualname__} cannot be sliced: state {name!r} declares "
                f"Reduction.{red.name}, which has no leading-axis slice semantics."
            )
        if not torch.equal(getattr(metric, name).cpu(), default):
            raise ValueError(
                "cannot slice a metric that already holds streamed batches; "
                "construct it fresh."
            )


def _build_member(
    template: Metric,
    table: SliceTable,
    *,
    curve_bucket_bits: Optional[int] = None,
    shard: Optional[MeshAxis] = None,
) -> _SlicedMemberBase:
    check_sliceable(template)
    if isinstance(template, _CurveMetric):
        return _SlicedScoreSketchMember(
            template, table, curve_bucket_bits=curve_bucket_bits, shard=shard
        )
    kind = _REDUCE_KINDS[type(template)._fold_reduce]
    return _FOLD_MEMBER_BY_KIND[kind](template, table, shard=shard)


# --------------------------------------------------------------- collection
class SlicedMetricCollection(MetricCollection):
    """Drive one metric set across many cohorts.

    Example::

        col = SlicedMetricCollection({"acc": BinaryAccuracy(), "auroc": BinaryAUROC(approx=1024)},
                                     capacity=4096)
        for slice_ids, scores, labels in stream:    # ids: any int64 cohorts
            col.update(slice_ids, scores, labels)
        results = col.compute()
        results["acc"].slice_ids, results["acc"]["values"]   # aligned 1:1

    ``metrics`` values are templates: each is expanded into an internal
    slice-axis member on the template's device, and the templates are left
    untouched. ``capacity`` seeds the dense row capacity, which grows
    geometrically. ``curve_bucket_bits`` sets the sketch members' width
    (4 to 20 bits; default the template's own). Every member receives the same update columns, so build
    separate collections for metrics fed from different tensors.

    ``mesh`` (a ``DeviceMesh``) with ``mesh_axis`` (one of its dim names)
    splits the slice axis over that dim's ranks (see the module doc); the
    capacity is rounded up to a multiple of the dim's size. Both are
    needed: the port builds no mesh of its own.
    """

    # serve ingest gate: the id column must stay on the HOST until it is
    # interned — the daemon's staging pass would otherwise copy it to the
    # device and force a read-back per batch, so sliced tenants keep the
    # per-batch path (``serve/daemon.py``)
    _host_ingest_only = True

    def __init__(
        self,
        metrics: Dict[str, Metric],
        *,
        capacity: int = _DEFAULT_CAPACITY,
        curve_bucket_bits: Optional[int] = None,
        mesh: Any = None,
        mesh_axis: Optional[str] = None,
    ) -> None:
        if isinstance(metrics, Metric):
            metrics = {"metric": metrics}
        if mesh is not None and mesh_axis is None:
            raise ValueError("mesh requires mesh_axis: name the mesh dim the slice axis shards over.")
        if mesh_axis is not None and mesh is None:
            raise ValueError(
                "mesh_axis requires mesh: pass the torch.distributed DeviceMesh that has the dim "
                f"{mesh_axis!r}."
            )
        shard = _dist.mesh_axis(mesh, mesh_axis) if mesh is not None else None
        self._slice_shard = shard
        self.slice_table = SliceTable(capacity, granularity=shard.size if shard is not None else 1)
        members = {
            name: _build_member(
                template, self.slice_table, curve_bucket_bits=curve_bucket_bits, shard=shard
            )
            for name, template in dict(metrics).items()
        }
        super().__init__(members)
        self._single = False  # sliced results are always keyed by name
        self._device = next(iter(self.metrics.values())).device

    def update(self, slice_ids, *args, **kwargs) -> "SlicedMetricCollection":
        """One batch: ``slice_ids`` (int cohort ids, a numpy array or a
        tensor; a CUDA tensor is read back to the host for interning) and the
        members' update columns. A batch rejected during growth rolls the id
        table back; a batch rejected by column validation after a growth may
        leave its new cohorts registered with default state."""
        if kwargs:
            raise ValueError(
                "SlicedMetricCollection.update takes positional columns only: "
                "(slice_ids, *update_args)."
            )
        if not args:
            raise ValueError("update needs at least one metric column after slice_ids.")
        rows = self._intern_and_grow(_to_numpy(slice_ids))
        # the rows are placed like any numpy column, so the window owns them
        return self._update_impl((rows, *args), {}, False)

    def update_placed(self, args: tuple, *, owned: bool = False) -> "SlicedMetricCollection":
        """An ingest pipeline's entry: ``args[0]`` is the host id column,
        the other columns may already be on the device (JAX:
        ``sliced.py:1224-1229``). ``owned`` as in
        :meth:`MetricCollection.update_placed`."""
        rows = self._intern_and_grow(_to_numpy(args[0]))
        return self._update_impl((rows, *args[1:]), {}, owned)

    def _intern_and_grow(self, slice_ids: np.ndarray) -> np.ndarray:
        """Intern a batch; if the members reject the grown capacity, the
        table rolls back to its state before the batch."""
        mark = self.slice_table.mark()
        rows, grew = self.slice_table.intern(slice_ids)
        if grew:
            try:
                self._grow_members()
            except BaseException:
                self.slice_table.rollback(mark)
                raise
        return rows

    def _grow_members(self) -> None:
        for m in self.metrics.values():
            m._check_capacity(self.slice_table.capacity)
        for m in self.metrics.values():
            m._grow_to(self.slice_table.capacity)

    def merge_collections(self, others: List["SlicedMetricCollection"]) -> "SlicedMetricCollection":
        """Merge replica collections member by member, by original id. The
        sources are not changed. Fails closed: the union capacity is checked
        against every member before any member merges."""
        union = self.slice_table.registered_ids()
        for other in others:
            union = np.union1d(union, other.slice_table.registered_ids())
        cap = self.slice_table.predict_growth(int(union.shape[0]))
        for m in self.metrics.values():
            m._check_capacity(cap)
        if self._window is not None:
            self._window.close()
        for other in others:
            if other._window is not None:
                other._window.close()
            for name, member in self.metrics.items():
                member.merge_state([other.metrics[name]])
        return self

    def __getstate__(self) -> Dict[str, Any]:
        # the members pickle unsharded (each gathers its tiles): the copy
        # holds no mesh
        state = super().__getstate__()
        state["_slice_shard"] = None
        return state

    def reset(self) -> "SlicedMetricCollection":
        """Reset every member and forget the observed cohorts (the capacity
        stays grown)."""
        super().reset()
        self.slice_table.clear()
        return self


# ------------------------------------------------------------ sync alignment
def align_sliced_gathered(
    metric: _SlicedMemberBase, gathered: List[Dict[str, Any]]
) -> List[Dict[str, Any]]:
    """Remap every replica's gathered sliced states onto the sorted union of
    their id tables, before the ordinary per-reduction fold.

    ``gathered`` holds one state dict per replica (tensors or numpy arrays,
    as ``state_dict()`` gives them). Pure host work: the union is a function
    of the gathered id lanes, so every rank computes the same table with no
    further collective. Each replica's rows scatter into buffers filled with
    the state's default (the reduce's identity), after which SUM, MAX and
    MIN fold elementwise; the id lanes of every entry become the union's.
    Returns numpy state dicts."""
    per_rank = []
    for g in gathered:
        count = int(_to_numpy(g["slice_count"]))
        hi = _to_numpy(g["slice_ids_hi"])[:count]
        lo = _to_numpy(g["slice_ids_lo"])[:count]
        per_rank.append((_unpack_ids(hi, lo), count))
    all_ids = (
        np.concatenate([ids for ids, _ in per_rank]) if per_rank else np.empty(0, np.int64)
    )
    union, inverse = np.unique(all_ids, return_inverse=True)
    inverse = inverse.reshape(-1)
    union_hi, union_lo = _pack_ids(union)
    u = int(union.shape[0])
    offset = 0
    aligned: List[Dict[str, Any]] = []
    for g, (_, count) in zip(gathered, per_rank):
        rows = inverse[offset : offset + count]
        offset += count
        out = {k: _to_numpy(v) for k, v in g.items()}
        for name in metric._sliced_state_names:
            arr = out[name]
            row_default = metric._row_defaults[name].numpy().astype(arr.dtype)
            buf = np.broadcast_to(row_default, (u,) + arr.shape[1:]).copy()
            buf[rows] = arr[:count]
            out[name] = buf
        out["slice_ids_hi"] = union_hi
        out["slice_ids_lo"] = union_lo
        out["slice_count"] = np.asarray(u, np.int32)
        aligned.append(out)
    return aligned
