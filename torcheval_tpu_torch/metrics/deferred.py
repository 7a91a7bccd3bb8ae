"""Deferred folds: ``update()`` appends the batch, and the math runs later.

JAX counterpart: ``torcheval_tpu/metrics/deferred.py``. A deferring metric
does not fold per batch. ``update()`` validates the batch's shapes and types
(once per signature), and appends the placed tensors to a **pending list**.
The fold runs later, over all the pending batches at once, when:

* the logical state is read: ``compute``, ``state_dict``,
  ``load_state_dict``, ``to``, ``merge_state``, ``_prepare_for_merge_state``
  (every sync), pickling and deepcopy;
* the **valve** opens: the pending batches hold ``_DEFER_BUDGET_BYTES``
  (256 MB) or ``_DEFER_MAX_CHUNKS`` (256) batches. A metric that a
  collection manages and that is streamed into directly folds at twice
  that.

A fold has one of two shapes, picked per pending list:

* **stacked** (``_fold_per_chunk`` True: per-sample folds reduced by a sum,
  max or min, such as accuracy, MSE and the aggregations). When every
  pending batch has one shape and type, the batches are stacked into one
  ``(batches, ...)`` operand per column, ``_fold_fn`` runs over the leading
  axis under ``torch.func.vmap``, the per-batch deltas are reduced over that
  axis by the ``_fold_reduce``'s reduction, and the state is combined with
  them once. A fold that cannot run under ``vmap`` (``_fold_vmap`` False:
  top-k accuracy and the retrieval metrics) runs batch by batch and combines
  each batch's deltas into the state in turn, as the JAX ``lax.scan`` does.
  Ragged batches accumulate their deltas batch by batch, then combine once,
  unless every delta is an exact integer count (``_fold_exact``: the
  accuracies), whose ragged batches take the concat shape below;
* **concat** (``_fold_per_chunk`` False: count folds such as F1, and the
  sliced members; a single batch; an exact member's ragged batches). The
  pending columns are concatenated and folded once, so the count kernels
  see one large operand.

The structure, not only the result, is the JAX package's, so that float and
half-precision sums round as JAX's do: the sliced ``Sum``/``Mean`` of a window
of bfloat16 values equals JAX's exactly on the CPU. The one departure is the
exact members' ragged windows: integer counts added into integer states are
the same for any split of the rows, bit for bit, so one call over the
concatenated rows replaces the JAX package's call a batch.

**Windows.** A :class:`~torcheval_tpu_torch.metrics.collection.
MetricCollection` appends each batch once to an :class:`EvalWindow` that its
deferring members share, and closes the window with :func:`window_step`:
every member's fold over the window's batches and, at ``compute()``, every
member's ``_compute_fn``. Standalone metrics fed the same tensors (identity,
not value) fold together in one :func:`fold_pending` (group folds).

**No donation.** The JAX package donates state and, when the collection
placed them itself, the window's batches to the fold program, and pins the
donated inputs until the program retires. PyTorch has neither need: a fold
writes new state tensors out of place, and the caching allocator orders a
freed block's reuse on its stream, so a window may drop its references to
the batches as soon as the fold is enqueued. "Owned" keeps the JAX meaning
(the collection placed the buffer itself, from numpy or a CPU tensor) and
decides only whether a window may release the batches before the fold math
runs (after building its stacked or concatenated operands).

**Mutable inputs.** A window holds the caller's tensors past ``update()``,
and a caller who rewrites one in place would change the result silently.
Each batch's tensors' version counters (``tensor._version``) are recorded at
the append and compared at the fold, which raises ``RuntimeError`` if one
moved. The counter cannot see memory rewritten outside autograd's tracking:
a static CUDA-graph output replayed into, writes through ``tensor.data`` or
through a numpy or DLPack view, and tensors made under
``torch.inference_mode()``, which carry no counter. Pass a fresh tensor to
``update()``, or read the state first.

**Transforms.** An update made during CUDA-graph capture, under a
``torch.func`` transform or while ``torch.compile`` traces folds at once, so
no wrapped or captured tensor outlives its transform in a pending list.

**Observability** (``obs/``, while enabled), at the JAX package's call
sites and under its names: :func:`window_step` counts
``deferred.window_steps{path=stacked|concat|compute}``, the batches it
folds (``deferred.window_step_batches``, the ``deferred.window_occupancy``
histogram) and lands a ``deferred.window_step.dispatch`` bar on the
timeline; :func:`fold_pending` counts ``deferred.folds{entry=fold|
group_fold,path=}`` and ``deferred.folded_chunks{entry=}`` with a
``deferred.fold.dispatch`` instant; a window lands
``deferred.window.open/append/close`` instants, and the collection's valve
``deferred.window.valve``. ``path`` follows the JAX gate: ``stacked``
unless a batch holds a tensor subclass (the JAX package's mesh-sharded
chunks), whatever each member's fold shape. The overlap of a window's fill
with the previous window step's execution is the
``deferred.window.overlap_ms`` histogram: each window step on the card
records a CUDA event after its work, and the next window's appends poll it
with ``Event.query()``, which never blocks (the JAX package polls its
output's ``is_ready()``); no event is recorded under a transform or a
graph capture. The three entry points are watched by the recompile
watchdog (``deferred.fold_pending``, ``deferred.group_fold``,
``deferred.window_step``). Inside a window step or fold, spans (registry
and profiler range, ``obs/annotate.py::spanned``) mark the operands
(``deferred.operands``: the stacks and concatenations), each member's
fold and, apart, its combine into state (``deferred.fold/<Class>``,
``member=`` its collection key, ``shape=stacked|scan|ragged|concat``; the
vmapped members' one call is ``deferred.fold/stacked``, ``members=``) and
each terminal compute (``deferred.compute_fn/<Class>``, ``member=``);
``deferred.fold_calls{shape=}`` counts the ``_fold_fn`` calls each shape
makes (one a member for stacked and concat, one a batch for scan and
ragged). Labels are built behind a call-site ``if _obs._enabled`` guard,
so the disabled path allocates nothing.

Contract for subclasses::

    def _my_fold(input, target, threshold):   # module level, pure
        return {"num_tp": ..., "num_fp": ...}  # batches -> {state: delta}

    def _my_compute(num_tp, num_fp, threshold):  # states in registration order
        return ...

    class MyMetric(DeferredFoldMixin, Metric[torch.Tensor]):
        _fold_fn = staticmethod(_my_fold)
        _fold_per_chunk = True                  # stacked; False: concat
        _compute_fn = staticmethod(_my_compute)

        def __init__(self, ..., device=None):
            super().__init__(device=device)
            self._add_state(...)
            self._init_deferred()
            self._fold_params = (threshold,)
            self._compute_params = (threshold,)

        def _update_check(self, input, target): ...   # shapes and types only

        def update(self, input, target):
            self._defer(self._input(input), self._input(target))
            return self

        def compute(self):
            return self._deferred_compute()

        def merge_state(self, metrics):
            for m in self._fold_for_merge(metrics):   # folds both sides first
                ...

Reading a state attribute directly (``m.num_total``) between updates gives
the folded-so-far value; ``state_dict()`` and ``compute()`` fold first.
"""

from __future__ import annotations

import itertools
import time
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from torcheval_tpu_torch.obs import registry as _obs
from torcheval_tpu_torch.obs import trace as _trace
from torcheval_tpu_torch.obs.annotate import _under_transform, instrument_protocol, spanned
from torcheval_tpu_torch.obs.recompile import watched

Chunk = Tuple[torch.Tensor, ...]
Versions = Tuple[Optional[int], ...]

# Live standalone deferring metrics: a metric that folds looks here for peers
# whose pending batches are the same tensors (metrics fed the same stream
# outside any collection) and folds them in one go. Weak: registration keeps
# no metric alive.
_live_deferred: "weakref.WeakSet" = weakref.WeakSet()
_defer_seq = itertools.count(1)

# a CUDA event recorded after the last window step on the card (obs
# enabled): the anchor of the fill/execute overlap histogram
_last_window_event: Optional[torch.cuda.Event] = None


def _window_step_running() -> bool:
    """True while the last window step's work is still on the card
    (``Event.query()`` never blocks; once it reports the work done, the
    event is dropped, so later appends ask the card nothing)."""
    global _last_window_event
    if _last_window_event is None:
        return False
    if _last_window_event.query():
        _last_window_event = None
        return False
    return True


def _chunks_identical(a: Sequence[Chunk], b: Sequence[Chunk]) -> bool:
    """Two pending lists hold the same tensor objects in the same order."""
    return len(a) == len(b) and all(
        len(c) == len(h) and all(x is y for x, y in zip(c, h)) for c, h in zip(a, b)
    )


def _is_prefix(short: Sequence[Chunk], long: Sequence[Chunk]) -> bool:
    """``short`` is an identity prefix of ``long``: peers fed one stream are
    usually a batch apart mid-loop, so the common part folds together."""
    return len(short) <= len(long) and _chunks_identical(short, long[: len(short)])


def _uniform_chunks(chunks: Sequence[Chunk]) -> bool:
    """Every batch has one arity and the same shape and type per column."""
    head = chunks[0]
    for c in chunks[1:]:
        if len(c) != len(head):
            return False
        for x, h in zip(c, head):
            if x.shape != h.shape or x.dtype != h.dtype:
                return False
    return True


def _add(state: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    return state + delta


def _sum0(v: torch.Tensor) -> torch.Tensor:
    # in the delta's own type, as jnp.sum keeps int32 (torch.sum widens it)
    return torch.sum(v, dim=0, dtype=v.dtype)


def _amax0(v: torch.Tensor) -> torch.Tensor:
    return torch.amax(v, dim=0)


def _amin0(v: torch.Tensor) -> torch.Tensor:
    return torch.amin(v, dim=0)


# _fold_reduce -> its reduction over the stacked batch axis
_AXIS_REDUCERS = {None: _sum0, torch.maximum: _amax0, torch.minimum: _amin0}


def _versions(args: Sequence[torch.Tensor]) -> Versions:
    """Each tensor's version counter; ``None`` for an inference tensor,
    which has none."""
    return tuple(None if a.is_inference() else a._version for a in args)


def _check_unchanged(owner: str, chunks: Sequence[Chunk], versions: Sequence[Versions]) -> None:
    for chunk, vers in zip(chunks, versions):
        for a, v in zip(chunk, vers):
            if v is not None and a._version != v:
                raise RuntimeError(
                    f"{owner}: a tensor passed to update() was modified in place after the "
                    "call and before its batch was folded, which would change the result "
                    "silently. Pass a fresh tensor to update(), or read the state with "
                    "compute() or state_dict(), which fold the pending batches, before "
                    "reusing the buffer."
                )


def _operands(
    chunks: Sequence[Chunk], stack: bool, cat: bool, scan: bool
) -> Tuple[Optional[Chunk], Optional[Chunk], Optional[List[Chunk]]]:
    """The window's operands: each column stacked (``stack``), each column
    concatenated (``cat``), and the scan's batches (``scan``; rows of the
    stack when there is one)."""
    stacked = tuple(torch.stack(cols) for cols in zip(*chunks)) if stack else None
    concat = (
        tuple(torch.cat(cols) if len(cols) > 1 else cols[0] for cols in zip(*chunks))
        if cat
        else None
    )
    seq = None
    if scan:
        seq = (
            [tuple(col[i] for col in stacked) for i in range(len(chunks))]
            if stacked is not None
            else list(chunks)
        )
    return stacked, concat, seq


def _stacked_deltas(
    members: Sequence[Tuple[str, "DeferredFoldMixin"]], stacked: Chunk
) -> Dict[str, List[Dict[str, torch.Tensor]]]:
    """Every stacked member's deltas from one ``vmap`` over the batch axis,
    reduced over it."""

    def all_deltas(*chunk):
        return {key: type(m)._fold_fn(*chunk, *m._fold_params) for key, m in members}

    delta_stacks = torch.func.vmap(all_deltas)(*stacked)
    out = {}
    for key, m in members:
        red = _AXIS_REDUCERS[type(m)._fold_reduce]
        out[key] = [{n: red(v) for n, v in delta_stacks[key].items()}]
    return out


def _scan_deltas(m: "DeferredFoldMixin", seq: Sequence[Chunk]) -> List[Dict[str, torch.Tensor]]:
    fn = type(m)._fold_fn
    return [fn(*c, *m._fold_params) for c in seq]


def _ragged_deltas(m: "DeferredFoldMixin", chunks: Sequence[Chunk]) -> List[Dict[str, torch.Tensor]]:
    fn = type(m)._fold_fn
    red = type(m)._fold_reduce or _add
    acc = None
    for c in chunks:
        d = fn(*c, *m._fold_params)
        acc = d if acc is None else {n: red(acc[n], v) for n, v in d.items()}
    return [acc]


def _concat_deltas(m: "DeferredFoldMixin", concat: Chunk) -> List[Dict[str, torch.Tensor]]:
    return [type(m)._fold_fn(*concat, *m._fold_params)]


def _member_fold(key: str, m: "DeferredFoldMixin", shape: str, fold: Callable, operand: Any, calls: int):
    """One member's ``fold(m, operand)``, which makes ``calls`` calls of its
    ``_fold_fn``: inside a ``deferred.fold/<Class>`` span while obs is
    enabled."""
    if not _obs._enabled:
        return fold(m, operand)
    _obs.counter("deferred.fold_calls", float(calls), shape=shape)
    return spanned(f"deferred.fold/{type(m).__name__}", {"member": key, "shape": shape}, fold, m, operand)


def _member_deltas(
    members: Sequence[Tuple[str, "DeferredFoldMixin"]],
    chunks: Sequence[Chunk],
    release: Optional[Callable[[], None]] = None,
) -> Tuple[Dict[str, List[Dict[str, torch.Tensor]]], Dict[str, str]]:
    """Each member's deltas over ``chunks``, as a list of delta dicts to
    combine into its state in order, and each member's fold shape
    (``stacked``, ``scan``, ``ragged`` or ``concat``). Nothing is combined
    here, so a fold that raises leaves every state as it was. ``release``
    (the window's owned batches) runs once every operand is built, before
    the fold math."""
    n = len(chunks)
    uniform = n > 1 and _uniform_chunks(chunks)
    stacked_members, scan_members, other = [], [], []
    shapes: Dict[str, str] = {}
    for key, m in members:
        cls = type(m)
        if uniform and cls._fold_per_chunk:
            if cls._fold_vmap and cls._fold_reduce in _AXIS_REDUCERS:
                stacked_members.append((key, m))
                shapes[key] = "stacked"
            else:
                scan_members.append((key, m))
                shapes[key] = "scan"
        else:
            other.append((key, m))
            # an exact member's counts do not depend on how the rows split
            per_batch = cls._fold_per_chunk and n > 1 and not cls._fold_exact
            shapes[key] = "ragged" if per_batch else "concat"
    wants = (
        bool(stacked_members),
        any(shapes[k] == "concat" for k, _ in other),
        bool(scan_members),
    )
    if _obs._enabled:
        stacked, concat, seq = spanned("deferred.operands", {}, _operands, chunks, *wants)
    else:
        stacked, concat, seq = _operands(chunks, *wants)
    ragged = any(shapes[k] == "ragged" for k, _ in other)
    if release is not None and not ragged and (not scan_members or stacked is not None):
        release()

    out: Dict[str, List[Dict[str, torch.Tensor]]] = {}
    if stacked_members:
        # one vmapped call runs every stacked member's fold: one span
        if _obs._enabled:
            k = len(stacked_members)
            _obs.counter("deferred.fold_calls", float(k), shape="stacked")
            labels = {"members": k, "shape": "stacked"}
            out.update(spanned("deferred.fold/stacked", labels, _stacked_deltas, stacked_members, stacked))
        else:
            out.update(_stacked_deltas(stacked_members, stacked))
    for key, m in scan_members:
        out[key] = _member_fold(key, m, "scan", _scan_deltas, seq, n)
    for key, m in other:
        if shapes[key] == "ragged":
            out[key] = _member_fold(key, m, "ragged", _ragged_deltas, chunks, n)
        else:
            out[key] = _member_fold(key, m, "concat", _concat_deltas, concat, 1)
    return out, shapes


def _apply_all(m: "DeferredFoldMixin", deltas: Sequence[Dict[str, torch.Tensor]]) -> None:
    for d in deltas:
        m._apply_deltas(d)


def _combine(
    members: Sequence[Tuple[str, "DeferredFoldMixin"]],
    folded: Tuple[Dict[str, List[Dict[str, torch.Tensor]]], Dict[str, str]],
) -> None:
    """Combine :func:`_member_deltas`' deltas into each member's state: inside
    the member's ``deferred.fold/<Class>`` span while obs is enabled."""
    outs, shapes = folded
    for key, m in members:
        deltas = outs.get(key, ())
        if _obs._enabled:
            labels = {"member": key, "shape": shapes[key]}
            spanned(f"deferred.fold/{type(m).__name__}", labels, _apply_all, m, deltas)
        else:
            _apply_all(m, deltas)


def _stack_allowed(chunks: Sequence[Chunk]) -> bool:
    """The JAX package's gate for its stacked path: plain tensors only (a
    tensor subclass, such as a ``DTensor``, stands where the JAX package's
    mesh-sharded chunks stand). The count label only: each member's fold
    shape is picked by :func:`_member_deltas`."""
    return all(type(a) is torch.Tensor for a in chunks[0])


def _window_signature(args: tuple, kwargs: dict) -> Tuple[Any, Any]:
    """The watchdog's signature of a window step or fold, with no tree of
    the window flattened: the members' names and classes and the flags and
    names among the other arguments (static), each batch's shapes and types
    (dynamic). The batches' version counters are checks, not inputs."""
    members, chunks = args[0], args[1]
    pairs = members.items() if isinstance(members, dict) else enumerate(members)
    static: List[Any] = [tuple((k, type(m).__qualname__) for k, m in pairs)]
    for a in (*args[2:], *(v for _, v in sorted(kwargs.items()))):
        if a is None or isinstance(a, (str, bool)):
            static.append(a)
        elif isinstance(a, (set, frozenset, tuple, list)) and all(isinstance(x, str) for x in a):
            static.append(tuple(sorted(a)))
    return tuple(static), tuple((tuple(t.shape), t.dtype) for c in chunks for t in c)


@watched(name="deferred.fold_pending", signature=_window_signature)
def fold_pending(
    members: Sequence["DeferredFoldMixin"], chunks: Sequence[Chunk], entry: str = "fold"
) -> None:
    """Fold ``chunks`` into every metric of ``members`` (one metric's own
    pending batches, or a group's shared prefix): the solo and group lane,
    counted under ``entry`` (``fold`` or ``group_fold``, the JAX package's
    dispatchers). The callers check the version counters and clear the
    pending lists."""
    pairs = [(str(i), m) for i, m in enumerate(members)]
    _combine(pairs, _member_deltas(pairs, chunks))
    if _obs._enabled:
        path = "stacked" if _stack_allowed(chunks) else "concat"
        _obs.counter("deferred.folds", entry=entry, path=path)
        _obs.counter("deferred.folded_chunks", float(len(chunks)), entry=entry)
        _trace.instant(
            "deferred.fold.dispatch", kind="window", entry=entry, path=path, chunks=len(chunks)
        )


@watched(name="deferred.group_fold")
def group_fold(members: Dict[str, "DeferredFoldMixin"]) -> None:
    """Fold every member's own pending batches at once when they hold the
    same tensors (members each fed the same batches through their own
    ``update``); else fold each member alone."""
    pending = [m for m in members.values() if m._pending]
    if not pending:
        return
    head = pending[0]._pending
    aligned = len(pending) == len(members) and all(
        _chunks_identical(m._pending, head) for m in pending[1:]
    )
    if not aligned:
        for m in pending:
            m._fold_own()
        return
    for m in pending:
        _check_unchanged(type(m).__name__, m._pending, m._pending_versions)
    fold_pending(pending, head, "group_fold")
    for m in pending:
        m._clear_pending()


@watched(name="deferred.window_step", signature=_window_signature)
def window_step(
    members: Dict[str, "DeferredFoldMixin"],
    chunks: Sequence[Chunk],
    versions: Optional[Sequence[Versions]] = None,
    compute_keys: Iterable[str] = (),
    owned_chunks: bool = False,
) -> Dict[str, Any]:
    """One whole-window step: fold ``chunks`` into every member's state and,
    for the ``compute_keys`` members with a ``_compute_fn``, run the terminal
    compute on the folded states. Returns ``{member name: result}``.

    ``versions`` are the batches' version counters at the append, checked
    before anything runs. ``owned_chunks`` vouches that the collection
    placed every batch itself: a list of them is then emptied once the fold's
    operands are built. The callers clear their pending lists (only after
    this returns, so a failing fold never discards batches it did not
    consume). Makes no host synchronisation."""
    compute_keys = set(compute_keys)
    computing = [
        (name, m)
        for name, m in members.items()
        if name in compute_keys and type(m)._compute_fn is not None
    ]
    n = len(chunks)
    if not n and not computing:
        return {}
    path, cuda, t0 = None, False, 0.0
    if _obs._enabled:
        # read before the fold: an owned list of batches is emptied by it
        path = ("stacked" if _stack_allowed(chunks) else "concat") if n else "compute"
        cuda = bool(n) and chunks[0][0].is_cuda and not _under_transform(chunks[0])
        t0 = time.perf_counter()
    if n:
        if versions is not None:
            names = ", ".join(type(m).__name__ for m in members.values())
            _check_unchanged(names, chunks, versions)
        pairs = list(members.items())
        release = chunks.clear if owned_chunks and isinstance(chunks, list) else None
        _combine(pairs, _member_deltas(pairs, chunks, release))
    results = {}
    for name, m in computing:
        if _obs._enabled:
            results[name] = spanned(
                f"deferred.compute_fn/{type(m).__name__}", {"member": name}, _terminal, m
            )
        else:
            results[name] = _terminal(m)
    if path is not None:
        _count_window_step(path, n, len(computing), t0)
        if cuda:
            # the overlap anchor: this step's work, enqueued on the stream
            global _last_window_event
            _last_window_event = torch.cuda.Event()
            _last_window_event.record()
    return results


def _terminal(m: "DeferredFoldMixin") -> Any:
    """A member's terminal ``_compute_fn`` on its folded states."""
    return type(m)._compute_fn(
        *(getattr(m, s) for s in m._state_name_to_default), *m._compute_params
    )


def _count_window_step(path: str, n: int, computes: int, t0: float) -> None:
    _obs.counter("deferred.window_steps", path=path)
    if n:
        _obs.counter("deferred.window_step_batches", float(n))
        # batches per window as a distribution: the valve cadence's health
        _obs.histo("deferred.window_occupancy", float(n))
    # host-side dispatch duration (the work runs asynchronously)
    _trace.complete(
        "deferred.window_step.dispatch",
        t0,
        time.perf_counter() - t0,
        kind="window",
        path=path,
        batches=n,
        computes=computes,
        donated=False,
    )


class EvalWindow:
    """The pending batches a collection's deferring members share.

    ``MetricCollection.update()`` appends each placed batch here once, and
    the window closes as one :func:`window_step`. ``owned`` says whether
    the collection placed every batch itself. ``sig`` caches the full
    ``(shape, dtype)`` signature the collection's fast path last validated.
    ``owner`` refers weakly to the collection: a member prunes the windows
    of collections that died, after folding their batches."""

    __slots__ = (
        "members",
        "chunks",
        "versions",
        "nbytes",
        "sig",
        "sig_nbytes",
        "owned",
        "owner",
        "_fill_t0",
        "_ov_open",
        "_ov_last",
        "__weakref__",
    )

    def __init__(self, members: Dict[str, "DeferredFoldMixin"], owner: Any = None) -> None:
        self.members = members
        self.chunks: List[Chunk] = []
        self.versions: List[Versions] = []
        self.nbytes = 0
        self.sig: Optional[Tuple[Any, ...]] = None
        self.sig_nbytes = 0
        self.owned = True
        # a window built without a collection counts as alive
        self.owner = weakref.ref(owner) if owner is not None else (lambda: self)
        # the overlap watermark (obs enabled): this window's fill start,
        # whether the last window step was still running when it began and
        # has been seen running at every append since, and the last moment
        # it was seen running
        self._fill_t0 = 0.0
        self._ov_open = False
        self._ov_last = 0.0

    def append(self, chunk: Chunk, versions: Versions, nbytes: int, owned: bool) -> None:
        if _obs._enabled:
            # the labels are built behind this call-site guard: the armed
            # update path allocates nothing while obs is disabled
            _trace.instant(
                "deferred.window.append" if self.chunks else "deferred.window.open",
                kind="window",
                chunks=len(self.chunks) + 1,
                bytes=nbytes,
            )
            self._track_overlap(bool(self.chunks))
        self.chunks.append(chunk)
        self.versions.append(versions)
        self.nbytes += nbytes
        self.owned = self.owned and owned

    def _track_overlap(self, filling: bool) -> None:
        """Advance the fill/execute overlap watermark: on a window's first
        append, open it if the last window step is still running; on later
        appends, move it while that work runs, and close it once it ran."""
        now = time.perf_counter()
        running = _window_step_running()
        if not filling:
            self._fill_t0 = now
            self._ov_open = running
            self._ov_last = now if running else 0.0
        elif self._ov_open:
            if running:
                self._ov_last = now
            else:
                self._ov_open = False

    def _record_overlap(self) -> None:
        """Record the closing window's fill/execute overlap in
        ``deferred.window.overlap_ms`` (before its own step runs)."""
        if not self._ov_last:
            return
        if self._ov_open and _window_step_running():
            # still running as this window closes: the whole fill overlapped
            self._ov_last = time.perf_counter()
        overlap_s = self._ov_last - self._fill_t0
        if overlap_s > 0.0:
            _obs.histo("deferred.window.overlap_ms", overlap_s * 1e3)
        self._ov_open = False
        self._ov_last = 0.0

    def clear(self) -> None:
        self.chunks = []
        self.versions = []
        self.nbytes = 0
        self.owned = True

    def close(self, compute_keys: Iterable[str] = ()) -> Dict[str, Any]:
        """Fold everything pending into the members' states and run the
        ``compute_keys`` members' computes. Whatever a computed member's
        state depends on folds first: its other collections' open windows,
        and the members' own pending batches (a member streamed into
        directly), in one group fold where those align."""
        compute_keys = tuple(compute_keys)
        if _obs._enabled:
            _trace.instant(
                "deferred.window.close",
                kind="window",
                chunks=len(self.chunks),
                computes=len(compute_keys),
            )
        for key in compute_keys:
            m = self.members.get(key)
            if m is None:
                continue
            for w in m._live_windows():
                if w is not self and w.chunks:
                    w.close()
        if any(m._pending for m in self.members.values()):
            group_fold(self.members)
        if _obs._enabled and self.chunks:
            self._record_overlap()
        # positional: a keyword call through the watched wrapper leaves a
        # block in CPython's caches on the disabled path
        results = window_step(
            self.members, self.chunks, self.versions, compute_keys, self.owned and bool(self.chunks)
        )
        self.clear()
        return results


class DeferredFoldMixin:
    """Mixin for tensor-state metrics whose update is a pure fold.

    Class attributes:

    * ``_fold_fn(*update_args, *_fold_params) -> {state: delta}``, a
      module-level function; an optional update argument (a weight) is an
      extra column, and the fold tells them apart by arity;
    * ``_fold_per_chunk``: True for per-sample folds reduced by
      ``_fold_reduce`` (the stacked shape), False for count folds (concat);
    * ``_fold_exact``: True when every delta is an integer count added into
      an integer state, so that any split of the rows gives the same state
      bit for bit (within the int32 counters' 2^31 rows, which the JAX
      package states too). A per-chunk member with it folds a ragged window's
      concatenated rows in one call, where one without it (any float sum,
      an extremum) folds batch by batch as the JAX package does;
    * ``_fold_reduce``: ``None`` adds deltas into state; ``torch.maximum``
      or ``torch.minimum`` threads extrema states instead;
    * ``_fold_vmap``: False when the fold cannot run under
      ``torch.func.vmap`` (a kernel with no batching rule): its batches fold
      one by one, and the metric stays out of the sliced collection;
    * ``_compute_fn(*states_in_registration_order, *_compute_params)``: the
      pure terminal compute, or ``None`` when compute has host-side
      behaviour (then ``compute()`` must call ``_fold_now()`` first);
    * ``_update_check(*update_args)``: the shape and type validation, run
      once per batch signature, or ``None``.
    """

    # 256 MB of pending update arguments before a fold is forced
    _DEFER_BUDGET_BYTES: int = 1 << 28
    # and at most 256 pending batches: under a constant batch shape every
    # valve fold sees one stacked shape
    _DEFER_MAX_CHUNKS: int = 256
    _defers = True  # MetricCollection: members that share the window

    _fold_fn: Optional[Any] = None
    _fold_per_chunk: bool = False
    _fold_exact: bool = False
    _fold_reduce: Optional[Any] = None
    _fold_vmap: bool = True
    _compute_fn: Optional[Any] = None
    _fold_params: Tuple[Any, ...] = ()
    _compute_params: Tuple[Any, ...] = ()
    _update_check: Optional[Any] = None

    def _init_deferred(self) -> None:
        self._pending: List[Chunk] = []
        self._pending_versions: List[Versions] = []
        self._pending_bytes = 0
        # (ndim, dtype, trailing shape) of the pending batches' columns
        self._pending_sig: Optional[Tuple[Any, ...]] = None
        # (shapes, dtypes, nbytes) of the last validated batch: the fast path
        self._defer_cache: Optional[Tuple[Any, ...]] = None
        # registration order: the stable order of a group's members
        self._defer_seq = next(_defer_seq)
        _live_deferred.add(self)

    def _clear_pending(self) -> None:
        self._pending = []
        self._pending_versions = []
        self._pending_bytes = 0

    # ------------------------------------------------------------ machinery
    def _defer(self, *args: torch.Tensor) -> None:
        if _under_transform(args):
            check = self._update_check
            if check is not None:
                check(*args)
            self._apply_deltas(type(self)._fold_fn(*args, *self._fold_params))
            return
        cache = self._defer_cache
        if cache is not None:
            shapes, dtypes, nbytes = cache
            if len(args) == len(shapes):
                for i, a in enumerate(args):
                    if type(a) is not torch.Tensor or a.shape != shapes[i] or a.dtype != dtypes[i]:
                        break
                else:
                    # the signature the last validated batch had: validation,
                    # the signature flush and the byte count are all
                    # functions of it
                    self._pending.append(args)
                    self._pending_versions.append(_versions(args))
                    pb = self._pending_bytes = self._pending_bytes + nbytes
                    if pb >= self._DEFER_BUDGET_BYTES or len(self._pending) >= self._DEFER_MAX_CHUNKS:
                        self._defer_budget_check()
                    return
        self._defer_slow(args)

    def _defer_slow(self, args: Chunk) -> None:
        check = self._update_check
        if check is not None:
            check(*args)
        sig = tuple((a.ndim, a.dtype, a.shape[1:]) for a in args)
        if self._pending and sig != self._pending_sig:
            # a change of arity, rank, trailing shape or type: one fold never
            # mixes signatures, so the old ones fold first
            self._fold_own()
        self._pending.append(args)
        self._pending_versions.append(_versions(args))
        self._pending_sig = sig
        nbytes = sum(int(a.nbytes) for a in args)
        self._pending_bytes += nbytes
        self._defer_cache = (tuple(a.shape for a in args), tuple(a.dtype for a in args), nbytes)
        self._defer_budget_check()

    def _over_budget(self, scale: int) -> bool:
        return (
            self._pending_bytes >= scale * self._DEFER_BUDGET_BYTES
            or len(self._pending) >= scale * self._DEFER_MAX_CHUNKS
        )

    def _defer_budget_check(self) -> None:
        # a collection owns its members' fold trigger; a managed member
        # streamed into directly still folds itself at twice the budget
        scale = 2 if getattr(self, "_defer_managed", False) else 1
        if self._over_budget(scale):
            # peers fed the same stream are a batch behind at most: the
            # shared prefix frees almost everything in one fold
            self._group_fold_attempt()
            if self._over_budget(scale):
                self._fold_own()

    def _apply_deltas(self, deltas: Dict[str, torch.Tensor]) -> None:
        """Merge deltas into the state, out of place (a scalar state may
        widen to the delta's shape or type, as in the JAX package: an
        unweighted int32 count becomes float32 under a weighted update)."""
        red = type(self)._fold_reduce or _add
        for name, delta in deltas.items():
            setattr(self, name, red(getattr(self, name), delta))

    def _group_fold_attempt(self) -> None:
        """Fold the longest identity prefix of pending batches shared with
        live standalone peers in one fold; the batches past it stay
        pending on their owners."""
        pending = self._pending
        if not pending or getattr(self, "_defer_managed", False):
            return
        peers = [
            m
            for m in _live_deferred
            if m is not self
            and not getattr(m, "_defer_managed", False)
            and m.device == self.device
            and m._pending
            and (_is_prefix(m._pending, pending) or _is_prefix(pending, m._pending))
        ]
        if not peers:
            return
        group = sorted([self, *peers], key=lambda m: (type(m).__qualname__, m._defer_seq))
        common = min(len(m._pending) for m in group)
        chunks = self._pending[:common]
        if not all(_is_prefix(chunks, m._pending) for m in group):
            return
        for m in group:
            _check_unchanged(type(m).__name__, chunks, m._pending_versions[:common])
        fold_pending(group, chunks, "group_fold")
        for m in group:
            m._pending = m._pending[common:]
            m._pending_versions = m._pending_versions[common:]
            m._pending_bytes = sum(int(a.nbytes) for c in m._pending for a in c)

    def _live_windows(self) -> Tuple[EvalWindow, ...]:
        """The shared windows this metric belongs to, after pruning those
        whose collection died (their batches fold first: they carry updates
        the caller made)."""
        windows = getattr(self, "_defer_windows", None)
        if not windows:
            return ()
        for w in [w for w in windows if w.owner() is None]:
            if w.chunks:
                w.close()
            windows.remove(w)
        return tuple(windows)

    def _fold_now(self) -> None:
        """Fold every batch this metric's logical state depends on: the open
        windows of every collection it belongs to, then its own pending."""
        for w in self._live_windows():
            if w.chunks:
                w.close()
        self._fold_own()

    def _fold_own(self) -> None:
        """Fold this metric's own pending batches: with the standalone peers
        that share a prefix of them, then the rest alone."""
        if not self._pending:
            return
        self._group_fold_attempt()
        pending = self._pending
        if not pending:
            return
        _check_unchanged(type(self).__name__, pending, self._pending_versions)
        fold_pending((self,), pending)
        # cleared after the fold: a fold that raises keeps every batch
        self._clear_pending()

    def _fold_for_merge(self, metrics: Iterable["DeferredFoldMixin"]) -> List["DeferredFoldMixin"]:
        """Fold this metric and the merge sources before ``merge_state``
        reads their states; the sources as a list."""
        metrics = list(metrics)
        self._fold_now()
        for m in metrics:
            m._fold_now()
        return metrics

    def _on_window_result(self, result):
        """Host-side post-processing of a ``_compute_fn`` result, as the
        metric's own ``compute()`` would apply it. Default: identity."""
        return result

    def _deferred_compute(self):
        """``compute()`` body for metrics with a pure ``_compute_fn``: the
        fold and the terminal compute in one window step (this metric's own,
        or the close of the last open window it belongs to, which drains its
        other windows first)."""
        open_windows = [w for w in self._live_windows() if w.chunks]
        if open_windows:
            last = open_windows[-1]
            key = next(k for k, v in last.members.items() if v is self)
            results = last.close(compute_keys=(key,))
            if key in results:
                return self._on_window_result(results[key])
        elif self._pending:
            if not getattr(self, "_defer_managed", False):
                self._group_fold_attempt()
            if self._pending:
                results = window_step(
                    {"s": self}, tuple(self._pending), self._pending_versions, ("s",)
                )
                self._clear_pending()
                if "s" in results:
                    return self._on_window_result(results["s"])
        return self._on_window_result(_terminal(self))

    # ------------------------------------------------------ lifecycle hooks
    def reset(self):
        for w in self._live_windows():
            if w.chunks:
                # a shared window's batches belong to every member: fold
                # them so the siblings keep theirs (this member's share lands
                # in state the reset wipes next)
                w.close()
        self._clear_pending()
        self._pending_sig = None
        self._defer_cache = None
        return super().reset()

    # load_state_dict needs no override: Metric.load_state_dict folds into
    # the old state before it overwrites, which keeps a partial load exact
    # for the states it does not name.

    def __getstate__(self) -> Dict[str, Any]:
        # pickling and deepcopy fold first and carry nothing pending; a copy
        # answers to no collection
        self._fold_now()
        state = dict(self.__dict__)
        for name in ("_defer_managed", "_defer_windows", "_defer_cache"):
            state.pop(name, None)
        state["_pending"] = []
        state["_pending_versions"] = []
        state["_pending_bytes"] = 0
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._clear_pending()
        self._pending_sig = None
        self._defer_cache = None
        _live_deferred.add(self)  # a restored metric groups with peers again


# the mixin's reset (a window close, then the base's) under the metric's
# ``metric.reset/<Class>`` span
instrument_protocol(DeferredFoldMixin, ("reset",))
