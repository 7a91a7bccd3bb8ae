"""Cross-process metric sync on ``torch.distributed``.

JAX counterpart: ``torcheval_tpu/metrics/toolkit.py``. A user who runs one
process per GPU streams each rank's batches into its own metric replica;
these functions merge the replicas into a global result. Every state
declares a :class:`~torcheval_tpu_torch.metrics.state.Reduction`, and the
states of a metric, or of a whole collection, cross the wire as typed bytes
in exactly two collective rounds (:func:`_gather_collection_states`):

1. one ``all_gather`` of an ``(n_entries + 1, 9)`` int32 descriptor matrix:
   a schema digest row, then per state ``[d0, ndim, dtype_code, d1, d2, d3,
   d4, codec, enc_nbytes]`` (``ndim == -1``: an empty CAT cache), with the
   JAX package's dtype codes and entry order;
2. one ``all_gather`` of every state's bytes (raw, or encoded by the entry's
   codec) concatenated into a uint8 payload, padded to the longest rank's.

Each rank then folds the gathered states by their declared reductions. A
WINDOW (bounded deque) state is cut, between the rounds, to the rows that
survive the fold, so the payload carries at most ``maxlen`` of its rows in
all. Dict-keyed and CUSTOM states travel instead through
``all_gather_object`` and fold by the metric's own ``merge_state``.

The collective buffers live on the backend's device: the host for gloo
(CUDA states are staged through it), the current CUDA device for NCCL, so
typed states on the card stay there. Synced metrics and their states land
on the source metric's device.

Semantics kept from the JAX package: ``recipient_rank`` an int or
``"all"``, with ``None`` (or ``{}``) on the other ranks; a warning and the
local result at world size 1; source metrics are never changed;
``processes=`` restricts a sync to a subgroup of global ranks (a
``torch.distributed.new_group`` that only its members create and enter);
``timeout_s`` bounds the whole sync and ``on_failure="local"`` turns a
timed-out or failed round into a warning and the local result.

**Quantized lanes.** With ``quantize=True`` (or, for ``quantize=None``,
``TORCHEVAL_TPU_SYNC_QUANTIZE`` set on; ``quantize=False`` opts out
whatever the environment says), the additive entries (``SUM``, ``MAX``,
``MIN``) are encoded before the descriptor round by the JAX package's
codecs (``utils/quant.py``, the same bytes), and the codec id travels in
the descriptor's ``codec`` column with the encoded length in
``enc_nbytes``, so every rank decodes every peer's entry from the
descriptors alone (ranks that disagree on the knob still interoperate):

* codec 1, **narrow** (lossless): integer lanes, min-offset narrowed;
  decoding widens to the declared type before the fold, so counts fold
  bit-exactly;
* codec 3, **bucket** (lossless): integer lanes again, as their nonzero
  entries only (the sparse sketch histograms); raced against codec 1 per
  entry, and the smaller ships;
* codec 2, **q8** (bounded error): float32 ``SUM`` lanes of at least
  ``Q8_MIN_ELEMENTS`` (64) elements, int8 blocks of 256 with a float32
  scale each; an element is off by at most ``max|block| / 254`` for each
  rank that contributes it. A lane with a non-finite value ships raw, and
  ``toolkit.sync.quantize_fallbacks{reason=nonfinite}`` counts it.

An encoder that would not shrink an entry leaves it raw, so the codecs
only ever remove bytes. The sync stays two rounds. The encoding runs on a
host copy of the entry (what the gloo round stages anyway); under NCCL the
encoded bytes travel as a uint8 tensor on the card, and each encoded
entry is decoded on the host.

Observability (``obs/``, while enabled) keeps the JAX package's names and
call sites. Every round goes through :func:`_allgather_stacked`, which
counts ``toolkit.sync.rounds`` and ``toolkit.sync.payload_bytes``, records
the ``toolkit.sync.round{lane=,round=}`` span and the
``toolkit.sync.round_seconds{lane=}`` histogram and sets
``toolkit.sync.world_size``; the object lane's ``all_gather_object`` counts
its two rounds there too, and ``toolkit.sync.object_lane_bytes``. The
collection gather counts ``toolkit.sync.lane_bytes{lane=}`` and
``toolkit.sync.lane_bytes_encoded{lane=,codec=}``; a failed sync counts
``toolkit.sync.timeouts{policy=}``. The three entry points are annotated
(``toolkit.get_synced_metric``, ``toolkit.sync_and_compute``,
``toolkit.sync_and_compute_collection``). The fault-injection hook
(``resilience/chaos.py``) is called at the top of
:func:`_allgather_stacked`, so ``TORCHEVAL_TPU_CHAOS_ROUND=3`` means
"entering the second sync's descriptor round" in both packages.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import logging
import math
import pickle
import threading
import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, TypeVar, Union

import numpy as np
import torch
import torch.distributed as dist

from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.state import Reduction, TState
from torcheval_tpu_torch.obs import registry as _obs
from torcheval_tpu_torch.obs.annotate import traced
from torcheval_tpu_torch.resilience import chaos as _chaos
from torcheval_tpu_torch.utils import dist as _dist
from torcheval_tpu_torch.utils import quant as _quant
from torcheval_tpu_torch.utils.devices import DeviceLike
from torcheval_tpu_torch.utils.telemetry import log_once

_logger = logging.getLogger(__name__)

TMetric = TypeVar("TMetric", bound=Metric)
_RecipientRank = Union[int, str]


# ------------------------------------------------------- failure semantics
class SyncError(RuntimeError):
    """Base for explicit-sync failures (timeouts and in-round errors)."""


class SyncTimeoutError(SyncError):
    """A collective round did not complete within the sync deadline. Carries
    the failing ``round`` (``"descriptor"``, ``"payload"`` or ``"object"``),
    the ``lane`` (``"typed"`` or ``"object"``) and the ``timeout_s`` budget."""

    def __init__(self, round_label: str, lane: str, timeout_s: float) -> None:
        super().__init__(
            f"sync round {round_label!r} ({lane} lane) did not complete "
            f"within timeout_s={timeout_s}: a participating process is "
            "likely dead or stalled. Use on_failure='local' to degrade to "
            "local results instead of raising."
        )
        self.round = round_label
        self.lane = lane
        self.timeout_s = timeout_s


class SyncRoundError(SyncError):
    """A collective round failed (rather than hung) under a sync deadline,
    e.g. the transport reported a dead peer. The original error is
    ``__cause__``."""

    def __init__(self, round_label: str, lane: str, cause: BaseException) -> None:
        super().__init__(f"sync round {round_label!r} ({lane} lane) failed: {cause!r}")
        self.round = round_label
        self.lane = lane


_FAILURE_POLICIES = ("raise", "local")


def _check_failure_policy(on_failure: str) -> None:
    if on_failure not in _FAILURE_POLICIES:
        raise ValueError(f"on_failure must be one of {_FAILURE_POLICIES}, got {on_failure!r}.")


def _check_timeout_s(timeout_s: Optional[float]) -> None:
    """``None`` means no deadline; anything else must be a positive finite
    number of seconds (0, inf and NaN are caller bugs, refused before any
    collective)."""
    if timeout_s is None:
        return
    try:
        ok = math.isfinite(timeout_s) and timeout_s > 0
    except TypeError:
        ok = False
    if not ok:
        raise ValueError(
            f"timeout_s must be None or a positive finite number of seconds, got {timeout_s!r}."
        )


class _Deadline:
    __slots__ = ("expires_at", "timeout_s")

    def __init__(self, expires_at: float, timeout_s: float) -> None:
        self.expires_at = expires_at
        self.timeout_s = timeout_s


_deadline_local = threading.local()


@contextlib.contextmanager
def _sync_deadline(timeout_s: Optional[float]):
    """Install a deadline for the calling thread: every round dispatched
    under it runs on a watchdog (:func:`_run_guarded`), and all rounds
    share the one budget."""
    if timeout_s is None:
        yield
        return
    _check_timeout_s(timeout_s)
    prev = getattr(_deadline_local, "deadline", None)
    _deadline_local.deadline = _Deadline(time.monotonic() + timeout_s, timeout_s)
    try:
        yield
    finally:
        _deadline_local.deadline = prev


def _run_guarded(fn: Callable[[], Any], round_label: str, lane: str) -> Any:
    """Run one blocking collective round under the active deadline, if any.

    The round runs on a daemon thread that the caller joins with the
    remaining budget. On expiry the caller raises :class:`SyncTimeoutError`;
    the thread stays blocked in the collective (a collective cannot be
    cancelled), but as a daemon it never holds up the process's exit. An
    error raised by the round becomes :class:`SyncRoundError`."""
    deadline = getattr(_deadline_local, "deadline", None)
    if deadline is None:
        return fn()
    remaining = deadline.expires_at - time.monotonic()
    if remaining <= 0:
        raise SyncTimeoutError(round_label, lane, deadline.timeout_s)
    box: Dict[str, Any] = {}

    def _worker() -> None:
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - relayed to the caller
            box["error"] = e

    t = threading.Thread(target=_worker, name=f"toolkit-sync-{round_label}", daemon=True)
    t.start()
    t.join(remaining)
    if t.is_alive():
        raise SyncTimeoutError(round_label, lane, deadline.timeout_s)
    if "error" in box:
        raise SyncRoundError(round_label, lane, box["error"]) from box["error"]
    return box["value"]


def _sync_failure(err: SyncError, on_failure: str) -> None:
    """Count the failure and apply the policy: re-raise, or warn once
    (until ``obs.reset()``) and let the caller return its local result."""
    _obs.counter("toolkit.sync.timeouts", policy=on_failure)
    if on_failure == "raise":
        raise err
    log_once(
        "toolkit.sync.degraded",
        "explicit sync failed (%s); continuing with LOCAL (unsynced) results under "
        "on_failure='local'. Later syncs may degrade the same way; this warning is "
        "emitted once per process.",
        err,
    )


# --------------------------------------------------------------------- local
def clone_metric(metric: TMetric) -> TMetric:
    """A deep copy of ``metric``."""
    return copy.deepcopy(metric)


def clone_metrics(metrics: List[TMetric]) -> List[TMetric]:
    """Deep copies of ``metrics``."""
    return [clone_metric(m) for m in metrics]


def reset_metrics(metrics: List[TMetric]) -> List[TMetric]:
    """Reset every metric."""
    return [m.reset() for m in metrics]


def to_device(metrics: List[TMetric], device: DeviceLike, *args: Any, **kwargs: Any) -> List[TMetric]:
    """Move every metric's state to ``device``."""
    return [m.to(device, *args, **kwargs) for m in metrics]


def merge_metrics(metrics: List[TMetric]) -> Optional[TMetric]:
    """Merge replicas into a fresh metric without changing any of them."""
    if not metrics:
        return None
    base = clone_metric(metrics[0])
    return base.merge_state(clone_metrics(metrics[1:]))


# ----------------------------------------------------- typed state reduction
def _fold_states(
    gathered: List[Dict[str, TState]], reductions: Dict[str, Reduction]
) -> Dict[str, TState]:
    """Fold per-rank state dicts of tensors into one by each state's
    declared reduction; the tests feed simulated rank dicts."""
    out: Dict[str, TState] = {}
    for name, red in reductions.items():
        values = [sd[name] for sd in gathered]
        if red is Reduction.CAT:
            arrays: List[torch.Tensor] = []
            for v in values:
                if isinstance(v, (list, deque)):
                    if v:
                        arrays.append(torch.cat(list(v), dim=0))
                elif v.shape[0]:
                    arrays.append(v)
            out[name] = [torch.cat(arrays, dim=0)] if arrays else []
        elif red in (Reduction.SUM, Reduction.MAX, Reduction.MIN):
            op = {Reduction.SUM: torch.add, Reduction.MAX: torch.maximum, Reduction.MIN: torch.minimum}[red]
            acc = values[0]
            for v in values[1:]:
                acc = op(acc, v)
            out[name] = acc
        elif red is Reduction.NONE:
            out[name] = values[0]
        elif red is Reduction.WINDOW:
            # per-rank rows extend in rank order; the deque bound is imposed
            # again at install, where the declared maxlen is known
            rows: List[torch.Tensor] = []
            for v in values:
                rows.extend(v)
            out[name] = rows
        else:  # Reduction.CUSTOM
            raise NotImplementedError(
                f"State {name!r} declares Reduction.CUSTOM and cannot be synced with "
                "typed collectives; merge replicas explicitly with "
                "merge_metrics()/metric.merge_state()."
            )
    return out


# ------------------------------------------------------------ the wire format
# dtype codes are wire format, in the JAX package's order: extend only at
# the end
_CAT_DTYPES = (
    torch.float32,
    torch.int32,
    torch.bool,
    torch.bfloat16,
    torch.float16,
    torch.int8,
    torch.uint8,
    torch.uint32,
    torch.float64,
    torch.int64,
    torch.int16,
    torch.uint16,
    torch.uint64,
)
_MAX_CAT_RANK = 5
_DESC_COLS = 9
# codec ids are wire format, the JAX package's (module doc)
_SYNC_CODEC_RAW, _SYNC_CODEC_NARROW, _SYNC_CODEC_Q8, _SYNC_CODEC_BUCKET = 0, 1, 2, 3
_QUANT_LANES = (Reduction.SUM, Reduction.MAX, Reduction.MIN)
# the codecs' names on the lane counters, by codec id
_SYNC_CODEC_NAMES = ("raw", "narrow", "q8", "bucket")


def _encodable(red: Reduction, local: Optional[torch.Tensor]) -> bool:
    """Whether a codec could apply to the entry: an additive lane holding
    integers, or float32 of at least ``Q8_MIN_ELEMENTS`` under ``SUM``
    (only those are copied to the host to be encoded)."""
    if local is None or red not in _QUANT_LANES:
        return False
    if not (local.dtype.is_floating_point or local.dtype.is_complex or local.dtype == torch.bool):
        return True
    return red is Reduction.SUM and local.dtype == torch.float32 and local.numel() >= _quant.Q8_MIN_ELEMENTS


def _encode_sync_entry(red: Reduction, local: Optional[np.ndarray], quantize: bool) -> Tuple[int, Optional[bytes]]:
    """The wire codec for one entry and its encoded bytes: ``(codec id,
    bytes or None)``, raw (``(0, None)``) when quantization is off, the
    lane is not additive, or no encoding would shrink the entry. Integer
    lanes race the lossless narrow and bucket codecs and the smaller ships;
    a non-finite float32 lane ships raw and is counted in
    ``toolkit.sync.quantize_fallbacks{reason=nonfinite}``."""
    if not quantize or local is None or red not in _QUANT_LANES:
        return _SYNC_CODEC_RAW, None
    if local.dtype.kind in "iu":
        enc = _quant.narrow_int_encode(local)
        enc_b = _quant.bucket_payload_encode(local)
        if enc_b is not None and (enc is None or len(enc_b) < len(enc)):
            return _SYNC_CODEC_BUCKET, enc_b
        if enc is not None:
            return _SYNC_CODEC_NARROW, enc
    elif red is Reduction.SUM and local.dtype == np.float32 and local.size >= _quant.Q8_MIN_ELEMENTS:
        if not np.isfinite(local).all():
            _obs.counter("toolkit.sync.quantize_fallbacks", reason="nonfinite")
            return _SYNC_CODEC_RAW, None
        enc = _quant.q8_encode(local, check_finite=False)  # checked just above
        if enc is not None:
            return _SYNC_CODEC_Q8, enc
    return _SYNC_CODEC_RAW, None



def _decode_sync_entry(codec: int, wire: bytes, dtype: torch.dtype, shape: tuple) -> np.ndarray:
    """The inverse of :func:`_encode_sync_entry` for an encoded entry."""
    if codec == _SYNC_CODEC_Q8:
        return _quant.q8_decode(wire, shape)
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))  # an integer type
    if codec == _SYNC_CODEC_NARROW:
        return _quant.narrow_int_decode(wire, np_dtype, shape)
    if codec == _SYNC_CODEC_BUCKET:
        return _quant.bucket_payload_decode(wire, np_dtype, shape)
    raise ValueError(f"unknown sync codec {codec}")


def _check_cat_descriptors(name: str, all_desc: np.ndarray) -> None:
    """Checks after the exchange, on every rank's identical gathered
    descriptors, so a failure raises everywhere instead of hanging a peer
    in the next round."""
    max_rank = int(all_desc[:, 1].max()) if all_desc.size else 0
    if max_rank > _MAX_CAT_RANK:
        raise NotImplementedError(
            f"State {name!r} has rank {max_rank} on some process, above the sync "
            f"wire-format limit {_MAX_CAT_RANK}; reshape the state."
        )
    if all_desc.size and int(all_desc[:, 2].min()) < 0:
        raise NotImplementedError(
            f"State {name!r} has a dtype outside the sync wire-format allowlist "
            f"{[str(d)[6:] for d in _CAT_DTYPES]} on some process; cast the state."
        )


# ------------------------------------------------------------ process world
_ProcessGroup = Optional[Sequence[int]]


def _check_group_recipient(group: Optional[Tuple[int, ...]], recipient_rank: _RecipientRank) -> None:
    if group is not None and recipient_rank != "all" and recipient_rank not in group:
        raise ValueError(f"recipient_rank {recipient_rank} is not a member of processes={group}.")


_subgroups: Dict[Tuple[int, Tuple[int, ...]], Any] = {}


def _torch_group(group: Optional[Tuple[int, ...]]):
    """The ``torch.distributed`` process group for ``group``: None (the
    default group) for the whole world, else a group created once per world
    by its members alone (``use_local_synchronization``)."""
    if group is None:
        return None
    key = (id(dist.group.WORLD), group)
    if key not in _subgroups:
        _subgroups[key] = dist.new_group(ranks=list(group), use_local_synchronization=True)
    return _subgroups[key]


def _allgather_stacked(
    x: torch.Tensor,
    group: Optional[Tuple[int, ...]],
    round_label: str = "collective",
    lane: str = "typed",
) -> torch.Tensor:
    """``(n_members, *x.shape)``: every member's ``x`` in group order, on the
    collective device. Every typed round goes through here, which runs it
    under the active deadline and, while obs is enabled, counts it
    (module doc). The env-gated fault-injection hook
    (``resilience/chaos.py``) runs first: it counts rounds here and can kill
    or delay this process at a chosen round (a ``sync_and_compute`` is two
    rounds); disarmed, it costs one cached-config check."""
    _chaos.on_sync_round()
    pg = _torch_group(group)
    if not _obs._enabled:
        return _run_guarded(lambda: _dist.all_gather_stacked(x, pg), round_label, lane)
    t0 = time.perf_counter()
    with _obs.span("toolkit.sync.round", lane=lane, round=round_label):
        out = _run_guarded(lambda: _dist.all_gather_stacked(x, pg), round_label, lane)
    _count_round(1, x.numel() * x.element_size(), lane, time.perf_counter() - t0, group)
    return out


def _count_round(rounds: int, nbytes: int, lane: str, seconds: float, group) -> None:
    _obs.counter("toolkit.sync.rounds", float(rounds))
    _obs.counter("toolkit.sync.payload_bytes", float(nbytes))
    # the latency distribution per lane: a straggling rank is a fat p99
    # long before a deadline fires
    _obs.histo("toolkit.sync.round_seconds", seconds, lane=lane)
    _obs.gauge("toolkit.sync.world_size", len(group) if group is not None else _dist.world_size())


# ------------------------------------------------------- object-gather lane
def _tree_to_host(value):
    """A state container with every tensor on the CPU, so the pickled
    payload does not name a device; container types (defaultdict factory,
    deque maxlen) are kept."""
    if isinstance(value, dict):
        out = {k: _tree_to_host(v) for k, v in value.items()}
        if isinstance(value, defaultdict):
            d = defaultdict(value.default_factory)
            d.update(out)
            return d
        return out
    if isinstance(value, deque):
        return deque((_tree_to_host(v) for v in value), maxlen=value.maxlen)
    if isinstance(value, list):
        return [_tree_to_host(v) for v in value]
    if isinstance(value, torch.Tensor):
        return value.cpu()
    return value


def _allgather_object(obj: Any, group: Optional[Tuple[int, ...]] = None) -> List[Any]:
    """Every member's picklable ``obj``, in group order, through
    ``all_gather_object`` (its two collectives, the lengths and the padded
    pickles, count as two rounds). Only states the typed lanes cannot
    carry take this lane. While obs is enabled it counts both rounds, and
    the pickled payload (plus the 8-byte length word of the first round)
    as their bytes and as ``toolkit.sync.object_lane_bytes``."""
    world = len(group) if group is not None else _dist.world_size()
    out: List[Any] = [None] * world
    pg = _torch_group(group)
    if not _obs._enabled:
        _run_guarded(lambda: dist.all_gather_object(out, obj, group=pg), "object", "object")
        return out
    payload = len(pickle.dumps(obj))
    _obs.counter("toolkit.sync.object_lane_bytes", float(payload))
    t0 = time.perf_counter()
    with _obs.span("toolkit.sync.round", lane="object", round="object"):
        _run_guarded(lambda: dist.all_gather_object(out, obj, group=pg), "object", "object")
    _count_round(2, payload + 8, "object", time.perf_counter() - t0, group)
    return out


def _needs_object_sync(metric: Metric) -> bool:
    """True when some state cannot travel on the typed lanes: a dict-keyed
    state or a CUSTOM reduction. WINDOW deques ride the typed wire."""
    for name, red in metric._state_name_to_reduction.items():
        if red is Reduction.CUSTOM or isinstance(getattr(metric, name), dict):
            return True
    return False


def _merged_replicas(metric: TMetric, state_dicts: List[Dict[str, TState]]) -> TMetric:
    replicas = []
    for sd in state_dicts:
        rep = clone_metric(metric)
        rep.load_state_dict(sd)
        replicas.append(rep)
    return replicas[0].merge_state(replicas[1:])


def _object_synced_metric(
    metric: TMetric, recipient_rank: _RecipientRank, group: Optional[Tuple[int, ...]] = None
) -> Optional[TMetric]:
    """Sync for dict and CUSTOM states: gather every rank's state dict as a
    pickle and fold with the metric's own ``merge_state``."""
    gathered = _allgather_object(_tree_to_host(metric.state_dict()), group)
    if recipient_rank != "all" and _dist.rank() != recipient_rank:
        return None
    return _merged_replicas(metric, gathered)


# ------------------------------------------------------------ public sync API
def _check_recipient(recipient_rank: _RecipientRank) -> None:
    if not (isinstance(recipient_rank, int) or recipient_rank == "all"):
        raise ValueError(
            f"recipient_rank should be an integer or 'all', got {recipient_rank} instead."
        )


def _warn_world_of_one() -> None:
    _logger.warning("World size is 1, and metric(s) not synced. returning the input metric(s).")


@traced("toolkit.get_synced_metric")
def get_synced_metric(
    metric: TMetric,
    recipient_rank: _RecipientRank = 0,
    *,
    processes: _ProcessGroup = None,
    timeout_s: Optional[float] = None,
    on_failure: str = "raise",
    quantize: Optional[bool] = None,
) -> Optional[TMetric]:
    """Sync ``metric``'s states over every process, or over the
    ``processes`` subgroup, and return the merged metric on the recipient
    rank(s); ``None`` elsewhere. At world size 1 it warns and returns
    ``metric`` itself.

    Tensor and list states travel on the two-round typed wire; dict and
    CUSTOM states through ``all_gather_object`` and ``merge_state``.
    ``timeout_s`` bounds the whole sync. On expiry, or on a failed round,
    ``on_failure="raise"`` raises the :class:`SyncError` and ``"local"``
    warns once and returns a clone of the local (unsynced) metric on every
    calling rank. ``quantize`` engages the wire codecs of the additive
    lanes (module doc): integer lanes narrow losslessly, large float32
    ``SUM`` lanes quantize within a documented bound; ``None`` reads
    ``TORCHEVAL_TPU_SYNC_QUANTIZE`` and ``False`` keeps raw bytes."""
    _check_recipient(recipient_rank)
    _check_failure_policy(on_failure)
    _check_timeout_s(timeout_s)
    group = _dist.members(processes)
    _check_group_recipient(group, recipient_rank)
    world = len(group) if group is not None else _dist.world_size()
    if world == 1:
        _warn_world_of_one()
        return metric
    metric._prepare_for_merge_state()
    try:
        with _sync_deadline(timeout_s):
            if _needs_object_sync(metric):
                return _object_synced_metric(metric, recipient_rank, group)
            gathered = [
                per_rank["m"]
                for per_rank in _gather_collection_states(
                    {"m": metric}, group, quantize=_quant.sync_quantize_enabled(quantize)
                )
            ]
    except SyncError as err:
        _sync_failure(err, on_failure)
        return clone_metric(metric)
    if recipient_rank != "all" and _dist.rank() != recipient_rank:
        return None
    return _install_gathered(metric, gathered)


def _install_gathered(metric: TMetric, gathered: List[Dict[str, TState]]) -> TMetric:
    """A clone of ``metric`` holding the fold of every rank's gathered
    states, on ``metric``'s device."""
    device = metric.device
    if getattr(metric, "_sliced_sync", False):
        # ranks hold ragged cohort populations under private id->row maps:
        # remap every rank's rows onto the sorted union of ids (host work,
        # no extra collective), after which the slices fold elementwise
        from torcheval_tpu_torch.metrics.sliced import align_sliced_gathered

        gathered = [
            {k: torch.as_tensor(v).to(device) for k, v in g.items()}
            for g in align_sliced_gathered(metric, gathered)
        ]
    folded = _fold_states(gathered, metric._state_name_to_reduction)
    synced = clone_metric(metric)
    if getattr(metric, "_sliced_sync", False):
        # the fold is the unsharded layout: a slice-sharded member keeps
        # this rank's tiles of it (identity when unsharded)
        folded = synced._tiles_of(folded)
    for name, red in metric._state_name_to_reduction.items():
        value = folded[name]
        default = metric._state_name_to_default[name]
        if red is Reduction.CAT and not isinstance(default, (list, deque)):
            value = value[0] if value else torch.empty((0,), device=device)
        if red is Reduction.WINDOW:
            # keep the newest maxlen rows of the rank-ordered rows, as a
            # local merge_state would
            value = deque(value, maxlen=getattr(default, "maxlen", None))
        synced._set_states({name: value})
    if getattr(metric, "_sliced_sync", False):
        synced._adopt_state_shapes()
    return synced


def get_synced_state_dict(
    metric: Metric,
    recipient_rank: _RecipientRank = 0,
    *,
    processes: _ProcessGroup = None,
    timeout_s: Optional[float] = None,
    on_failure: str = "raise",
    quantize: Optional[bool] = None,
) -> Dict[str, TState]:
    """The globally merged ``state_dict``; ``{}`` on non-recipient ranks
    (the arguments as in :func:`get_synced_metric`)."""
    _check_timeout_s(timeout_s)
    synced = get_synced_metric(
        metric,
        recipient_rank,
        processes=processes,
        timeout_s=timeout_s,
        on_failure=on_failure,
        quantize=quantize,
    )
    return synced.state_dict() if synced is not None else {}


@traced("toolkit.sync_and_compute")
def sync_and_compute(
    metric: Metric,
    recipient_rank: _RecipientRank = 0,
    *,
    processes: _ProcessGroup = None,
    timeout_s: Optional[float] = None,
    on_failure: str = "raise",
    quantize: Optional[bool] = None,
) -> Optional[Any]:
    """Sync ``metric`` over every process (or the ``processes`` subgroup)
    and compute on the recipient rank(s); ``None`` elsewhere (the
    arguments as in :func:`get_synced_metric`)."""
    _check_timeout_s(timeout_s)
    synced = get_synced_metric(
        metric,
        recipient_rank,
        processes=processes,
        timeout_s=timeout_s,
        on_failure=on_failure,
        quantize=quantize,
    )
    return None if synced is None else synced.compute()


# ------------------------------------------------ batched collection sync
def _cat_cache_concat(value) -> Optional[torch.Tensor]:
    """A CAT state's non-empty cache entries as one tensor (None when
    empty)."""
    cache = list(value) if isinstance(value, (list, deque)) else [value]
    nonempty = [v for v in cache if v.ndim and v.shape[0]]
    return torch.cat(nonempty, dim=0) if nonempty else None


def _collection_entries(metrics: Dict[str, Metric]):
    """``(metric key, state name, reduction, local tensor or None)`` in the
    wire's entry order: metric keys in order, states in registration
    order."""
    entries = []
    for mkey, metric in metrics.items():
        sd = metric.state_dict()
        for name, red in metric._state_name_to_reduction.items():
            value = sd[name]
            if red is Reduction.CAT:
                local = _cat_cache_concat(value)
            elif red is Reduction.WINDOW:
                # per-update rows stacked: the leading axis keeps the
                # boundaries a CAT concat would lose
                local = torch.stack(list(value)) if len(value) else None
            else:
                local = value
            entries.append((mkey, name, red, local))
    return entries


def _encode_entry_descriptor(
    local: Optional[torch.Tensor], codec: int = _SYNC_CODEC_RAW, enc_nbytes: int = 0
) -> list:
    if local is None:
        return [0, -1, 0, 0, 0, 0, 0, 0, 0]  # empty CAT cache
    if local.ndim > _MAX_CAT_RANK:
        # encoded rather than raised: a one-sided raise here would hang the
        # peers; _check_cat_descriptors fails on every rank after the round
        return [0, local.ndim, 0, 0, 0, 0, 0, 0, 0]
    code = _CAT_DTYPES.index(local.dtype) if local.dtype in _CAT_DTYPES else -1
    shape = list(local.shape) + [0] * (_MAX_CAT_RANK - local.ndim)
    d0 = shape[0] if local.ndim else 1
    return [d0, local.ndim, code] + shape[1:_MAX_CAT_RANK] + [codec, enc_nbytes]


def _window_keep_counts(d0: np.ndarray, maxlen: int) -> np.ndarray:
    """Per-rank surviving row counts of one WINDOW entry, from every rank's
    row count ``d0`` (group order): rank r keeps its newest
    ``clamp(maxlen - rows_after_r, 0, d0_r)`` rows, where ``rows_after_r``
    counts the rows of the ranks after it. The kept counts total
    ``min(maxlen, sum(d0))``."""
    d0 = np.maximum(np.asarray(d0, dtype=np.int64), 0)
    rows_after = np.concatenate([np.cumsum(d0[::-1])[::-1][1:], np.zeros((1,), np.int64)])
    return np.clip(maxlen - rows_after, 0, d0)


def _entry_shape(desc: np.ndarray) -> tuple:
    ndim = int(desc[1])
    if ndim <= 0:
        return ()
    return (int(desc[0]),) + tuple(int(d) for d in desc[3 : 3 + ndim - 1])


def _entry_nbytes(desc: np.ndarray) -> int:
    ndim = int(desc[1])
    if ndim < 0:
        return 0
    if int(desc[7]):  # an encoded entry: its length is in the descriptor
        return int(desc[8])
    itemsize = torch.empty((), dtype=_CAT_DTYPES[int(desc[2])]).element_size()
    return math.prod(_entry_shape(desc)) * itemsize


def _schema_digest_row(metrics: Dict[str, Metric]) -> list:
    """The descriptor matrix's header row: the entry count and 24 bytes of a
    SHA-256 over the ordered ``(metric key, metric class, state name,
    reduction, config extra)`` schema, the JAX package's digest. The payload
    is decoded by position, so ranks that enumerate different entries must
    fail on every rank rather than fold bytes into the wrong states."""
    schema = []
    for mkey, metric in metrics.items():
        extra = tuple(getattr(metric, "_sync_schema_extra", ()))
        for name, red in metric._state_name_to_reduction.items():
            schema.append((mkey, type(metric).__qualname__, name, red.name) + extra)
    digest = hashlib.sha256(repr(schema).encode()).digest()[:24]
    return [len(schema)] + np.frombuffer(digest, dtype="<i4").tolist() + [0] * (_DESC_COLS - 7)


def _descriptor_matrix(metrics: Dict[str, Metric], entries, encodings=None) -> np.ndarray:
    """The ``(len(entries) + 1, 9)`` int32 matrix of round one
    (``encodings``: each entry's ``(codec, bytes or None)``, raw when
    None)."""
    if encodings is None:
        encodings = [(_SYNC_CODEC_RAW, None)] * len(entries)
    rows = [_schema_digest_row(metrics)] + [
        _encode_entry_descriptor(local, codec, len(enc) if enc is not None else 0)
        for (_, _, _, local), (codec, enc) in zip(entries, encodings)
    ]
    return np.asarray(rows, dtype=np.int32).reshape(len(entries) + 1, _DESC_COLS)


def _raw_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _gather_collection_states(
    metrics: Dict[str, Metric], group: Optional[Tuple[int, ...]] = None, quantize: bool = False
) -> List[Dict[str, Dict[str, TState]]]:
    """Every rank's states for a whole collection, in exactly two collective
    rounds (the whole world, or the ``group`` subgroup): per-rank
    ``{metric key: {state name: value}}`` in group order, each value on its
    metric's device (a CAT value as a one-element list, ``[]`` when that
    rank's cache was empty). ``quantize`` encodes the additive entries
    (module doc); the codec column of each rank's descriptors drives the
    decode of its entries."""
    world = len(group) if group is not None else _dist.world_size()
    entries = _collection_entries(metrics)
    encodings = [
        _encode_sync_entry(red, local.detach().cpu().numpy(), True)
        if quantize and _encodable(red, local)
        else (_SYNC_CODEC_RAW, None)
        for _, _, red, local in entries
    ]
    desc = torch.from_numpy(_descriptor_matrix(metrics, entries, encodings))
    all_desc = _allgather_stacked(desc, group, "descriptor", "typed").cpu().numpy()
    all_desc = all_desc.reshape(world, len(entries) + 1, _DESC_COLS).copy()
    # every rank checks the same gathered rows, so a raise happens on all
    header = all_desc[:, 0, :]
    if not (header == header[0]).all():
        raise RuntimeError(
            "Collection sync schema mismatch: ranks enumerated different (metric key, "
            f"state name, reduction, config) entries (digest rows: {header.tolist()}). "
            "Every process must build the collection with the same metric keys, "
            "construction order, metric types and fold-relevant configuration before "
            "calling sync."
        )
    all_desc = all_desc[:, 1:, :]
    for e, (mkey, name, _, _) in enumerate(entries):
        _check_cat_descriptors(f"{name} of metric {mkey}", all_desc[:, e, :])
    # WINDOW entries: cut each rank's rows to those that survive the maxlen
    # fold; every rank derives the same cut from the same descriptors
    my_pos = group.index(_dist.rank()) if group is not None else _dist.rank()
    entries = list(entries)
    for e, (mkey, name, red, local) in enumerate(entries):
        if red is not Reduction.WINDOW:
            continue
        maxlen = getattr(metrics[mkey]._state_name_to_default[name], "maxlen", None)
        if maxlen is None:
            continue
        keep = _window_keep_counts(all_desc[:, e, 0], maxlen)
        if (keep == np.maximum(all_desc[:, e, 0], 0)).all():
            continue
        all_desc[:, e, 0] = keep
        if local is not None:
            entries[e] = (mkey, name, red, local[local.shape[0] - int(keep[my_pos]) :])
    if _obs._enabled:
        _count_lane_bytes(entries, encodings)
    totals = [sum(_entry_nbytes(all_desc[r, e]) for e in range(len(entries))) for r in range(world)]
    max_total = max(max(totals), 1)
    coll_dev = _dist.collective_device(_torch_group(group))
    parts = [
        torch.frombuffer(bytearray(enc), dtype=torch.uint8).to(coll_dev)
        if enc is not None
        else _raw_bytes(local).to(coll_dev)
        for (_, _, _, local), (_, enc) in zip(entries, encodings)
        if local is not None
    ]
    pad = torch.zeros(max_total - totals[my_pos], dtype=torch.uint8, device=coll_dev)
    payload = torch.cat(parts + [pad])
    all_bytes = _allgather_stacked(payload, group, "payload", "typed")
    on_device: Dict[torch.device, torch.Tensor] = {}
    gathered: List[Dict[str, Dict[str, TState]]] = [{mkey: {} for mkey in metrics} for _ in range(world)]
    for r in range(world):
        offset = 0
        for e, (mkey, name, red, _) in enumerate(entries):
            d = all_desc[r, e]
            if int(d[1]) < 0:  # empty CAT
                gathered[r][mkey][name] = []
                continue
            nbytes = _entry_nbytes(d)
            device = metrics[mkey].device
            dtype = _CAT_DTYPES[int(d[2])]
            if int(d[7]):  # an encoded entry, decoded on the host
                wire = all_bytes[r, offset : offset + nbytes].cpu().numpy().tobytes()
                offset += nbytes
                value = torch.from_numpy(_decode_sync_entry(int(d[7]), wire, dtype, _entry_shape(d)))
                gathered[r][mkey][name] = value.to(device)
                continue
            if device not in on_device:
                on_device[device] = all_bytes.to(device)
            wire = on_device[device][r, offset : offset + nbytes]
            offset += nbytes
            # view(dtype) needs the entry's start aligned to its item size;
            # only a misaligned entry is copied (a copy starts aligned)
            if wire.storage_offset() % dtype.itemsize:
                wire = wire.clone()
            value = wire.view(dtype).reshape(_entry_shape(d))
            gathered[r][mkey][name] = [value] if red is Reduction.CAT else value
    return gathered


def _count_lane_bytes(entries, encodings) -> None:
    """Each reduction lane's raw bytes in the payload round (after the
    WINDOW cut) and what it put on the wire per codec; the two agree on
    every raw entry."""
    for (_, _, red, local), (codec, enc) in zip(entries, encodings):
        raw = float(local.numel() * local.element_size()) if local is not None else 0.0
        _obs.counter("toolkit.sync.lane_bytes", raw, lane=red.name)
        _obs.counter(
            "toolkit.sync.lane_bytes_encoded",
            float(len(enc)) if enc is not None else raw,
            lane=red.name,
            codec=_SYNC_CODEC_NAMES[codec],
        )


@traced("toolkit.sync_and_compute_collection")
def sync_and_compute_collection(
    metrics: Dict[str, Metric],
    recipient_rank: _RecipientRank = 0,
    *,
    processes: _ProcessGroup = None,
    timeout_s: Optional[float] = None,
    on_failure: str = "raise",
    quantize: Optional[bool] = None,
) -> Optional[Dict[str, Any]]:
    """Sync and compute a named collection of metrics in one gather pass:
    the typed states of every member in one two-round exchange, and the
    members that need the object lane in one ``all_gather_object``.
    Results follow :func:`sync_and_compute` per member, ``None`` on
    non-recipient ranks. ``timeout_s`` bounds all of the rounds; on failure
    with ``on_failure="local"`` every calling rank gets the local compute of
    every member."""
    _check_recipient(recipient_rank)
    _check_failure_policy(on_failure)
    _check_timeout_s(timeout_s)
    group = _dist.members(processes)
    _check_group_recipient(group, recipient_rank)
    world = len(group) if group is not None else _dist.world_size()
    if world == 1:
        _warn_world_of_one()
        return {name: m.compute() for name, m in metrics.items()} or None
    for m in metrics.values():
        m._prepare_for_merge_state()
    obj_lane = {k: m for k, m in metrics.items() if _needs_object_sync(m)}
    arr_lane = {k: m for k, m in metrics.items() if k not in obj_lane}
    try:
        with _sync_deadline(timeout_s):
            gathered = (
                _gather_collection_states(
                    arr_lane, group, quantize=_quant.sync_quantize_enabled(quantize)
                )
                if arr_lane
                else None
            )
            obj_gathered = (
                _allgather_object({k: _tree_to_host(m.state_dict()) for k, m in obj_lane.items()}, group)
                if obj_lane
                else None
            )
    except SyncError as err:
        _sync_failure(err, on_failure)
        return {name: m.compute() for name, m in metrics.items()} or None
    if recipient_rank != "all" and _dist.rank() != recipient_rank:
        return None
    out: Dict[str, Any] = {}
    for name, metric in arr_lane.items():
        out[name] = _install_gathered(metric, [g[name] for g in gathered]).compute()
    for name, metric in obj_lane.items():
        out[name] = _merged_replicas(metric, [payload[name] for payload in obj_gathered]).compute()
    return out or None
