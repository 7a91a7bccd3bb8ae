"""Atomic metric checkpoint/restore: the preemption-survival spine.

JAX counterpart: ``torcheval_tpu/resilience/snapshot.py``, whose on-disk
format this module writes and reads, so that a checkpoint taken by either
package restores into the other wherever the metric schemas match (the
schema digest is the sync wire's, ``toolkit._schema_digest_row``, equal in
both packages for the same metrics).

A multi-hour streaming eval on a preemptible machine loses every folded
state at the first preemption unless that state periodically reaches
durable storage. Every state holder of the port (a ``Metric``, a
``MetricCollection``, a ``SlicedMetricCollection``, a ``ShardedEvaluator``,
or a plain ``{name: Metric}`` dict) has one pair of entry points:

``save(obj, directory)``
    Folds any deferred pending batches first (``Metric._fold_now``: the
    checkpoint captures the *logical* state), reads every ``state_dict()``
    tree to the host and writes ONE checkpoint directory ``ckpt-<step>/``:

    * ``state.npz``: every array leaf, named ``a0..aN`` in (metric key,
      registered state order), exact bytes, uncompressed;
    * ``manifest.json``: ``format_version`` 1, the step, the **schema
      digest** (the ordered ``(key, class, state, reduction, config-extra)``
      scheme the sync wire validates), the payload's SHA-256, and per state
      its container (list, deque with ``maxlen``, dict with its keys).

    A bfloat16 leaf is written as its 2-byte words (``descr '<V2'``, as the
    JAX package writes it) and the state's entry names ``"bfloat16"`` for it
    in a ``"dtypes"`` list, so the port restores it bit for bit. The JAX
    package cannot restore such a leaf (its reader ignores ``"dtypes"``).

    The write is temp-then-rename: everything lands in a hidden ``.tmp-*``
    directory, is fsynced, and is published with a single ``os.replace``, so
    a crash at any earlier point leaves no ``ckpt-*`` entry and a reader can
    never observe a partial checkpoint. ``keep_last=N`` rotates old
    checkpoints after a successful publish.

``restore(obj, path)``
    Validates the SHA-256 and the schema digest *before* touching any
    metric state, and raises a structured :class:`CheckpointError`
    (``.reason`` in ``{"not_found", "corrupt_manifest", "corrupt_payload",
    "checksum_mismatch", "schema_mismatch", "unsupported"}``) instead of
    loading garbage. The payload is mapped read-only and decoded as
    zero-copy views (``utils/npz.py``). The leaves bound for one CUDA device
    are copied into ONE pinned staging buffer and cross to the device in one
    non-blocking copy, with one synchronisation before the metrics'
    ``load_state_dict``; leaves bound for the CPU are copied once (the
    mapped views are read-only). A placement error raises. A subsequent
    ``compute()`` is bit-identical to one taken at save time.

Multi-process note: checkpoints are **per-process**; each rank saves its
local replica into its own directory. A slice-sharded
``SlicedMetricCollection`` (``mesh=``) returns the global value from
``state_dict()``, which gathers over the slice group, so every rank of that
group calls ``save`` together; its sliced states' entries record
``sharded_mesh`` (``{mesh dim name: size}`` of the slice group). Such a
checkpoint restores into an unsharded collection (the global value) or into
one sharded over an equal mesh dim, and raises ``"unsupported"`` for a
target sharded any other way.

Observability (``torcheval_tpu_torch.obs``): the spans
``resilience.checkpoint.save`` and ``.restore``; the counters
``resilience.checkpoint.{saves,restores,bytes,tmp_gc,corrupt_skipped,
corrupt_quarantined,fallback_restores}``; timeline instants at publish,
restore and quarantine.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import time
import zipfile
from collections import defaultdict, deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.obs import registry as _obs
from torcheval_tpu_torch.obs import trace as _obs_trace
from torcheval_tpu_torch.resilience import chaos as _chaos
from torcheval_tpu_torch.utils.npz import NPZ_FORMAT_ERRORS, npz_views

_logger = logging.getLogger(__name__)

_FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_PAYLOAD = "state.npz"
_CKPT_PREFIX = "ckpt-"
_TMP_PREFIX = ".tmp-"
_CORRUPT_PREFIX = "corrupt-"
# a bfloat16 leaf on disk: its 2-byte words, under the JAX package's descr
_BF16_NAME = "bfloat16"
_BF16_DESCR = "<V2"
_RAW2 = np.dtype("V2")
# staging offsets: every leaf starts on a boundary any dtype can view from
_STAGE_ALIGN = 64

__all__ = [
    "CheckpointError",
    "save",
    "restore",
    "restore_latest_valid",
    "quarantine_checkpoint",
    "rotate_checkpoints",
    "latest_checkpoint",
    "list_checkpoints",
    "read_extra",
    "discover_checkpoints",
]


class CheckpointError(RuntimeError):
    """Structured checkpoint failure.

    ``reason`` is machine-readable: ``"not_found"`` (no checkpoint at the
    path), ``"corrupt_manifest"`` (unparseable/incomplete manifest),
    ``"corrupt_payload"`` (payload unreadable or missing leaves),
    ``"checksum_mismatch"`` (payload bytes differ from the manifest's
    SHA-256: bit rot or a torn copy), ``"schema_mismatch"`` (the checkpoint
    was taken from a different metric set/configuration than the restore
    target), ``"unsupported"`` (a state the format or this placement cannot
    carry).
    """

    def __init__(self, reason: str, message: str) -> None:
        super().__init__(f"[{reason}] {message}")
        self.reason = reason


# --------------------------------------------------------------- normalising
def _as_metrics(obj: Any) -> Dict[str, Any]:
    """Normalise every supported state holder to ``{key: Metric}``, the
    shape the sync toolkit's collection wire uses, so the schema digest is
    comparable across holder types. A bare ``Metric`` wraps under the fixed
    key ``"metric"``, so ``save(metric)`` then ``restore(fresh_metric)``
    round-trips."""
    from torcheval_tpu_torch.metrics.collection import MetricCollection
    from torcheval_tpu_torch.metrics.metric import Metric

    if isinstance(obj, Metric):
        return {"metric": obj}
    if isinstance(obj, MetricCollection):
        return dict(obj.metrics)
    # ShardedEvaluator (duck-typed: its members are ``.metrics``)
    metrics = getattr(obj, "metrics", None)
    if isinstance(metrics, dict) and metrics and all(
        isinstance(m, Metric) for m in metrics.values()
    ):
        return dict(metrics)
    if isinstance(obj, dict) and obj and all(isinstance(m, Metric) for m in obj.values()):
        return dict(obj)
    raise TypeError(
        "save/restore accepts a Metric, a MetricCollection, a "
        f"ShardedEvaluator, or a non-empty dict of Metrics; got {type(obj)!r}."
    )


def _schema_digest(metrics: Dict[str, Any]) -> List[int]:
    from torcheval_tpu_torch.metrics.toolkit import _schema_digest_row

    return [int(v) for v in _schema_digest_row(metrics)]


# ------------------------------------------------------------- tree flatten
_JSON_KEY_TYPES = (str, int, float, bool, type(None))


def _host_leaf(value: Any) -> Tuple[np.ndarray, Optional[str]]:
    """One state tensor as a C-contiguous host array, and the dtype name
    the manifest must carry for it (``"bfloat16"``, whose numpy form is its
    raw 2-byte words), else None."""
    t = torch.as_tensor(value).detach()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).cpu().numpy().view(_RAW2), _BF16_NAME
    return t.contiguous().cpu().numpy(), None


def _sharded_mesh_shape(metric: Any, name: str) -> Optional[dict]:
    """``{mesh dim: size}`` of the slice group a sliced state is split over
    (a slice-sharded member's sliced states), else None: replicated and
    unsharded state restores anywhere, see :func:`restore`."""
    shard = getattr(metric, "_shard", None)
    if shard is None or name not in getattr(metric, "_sliced_state_names", ()):
        return None
    return {str(shard.name): int(shard.size)}


def _flatten_states(
    metrics: Dict[str, Any],
) -> Tuple[Dict[str, np.ndarray], List[dict]]:
    """Flatten every metric's state tree into named npz leaves plus a
    manifest entry per state carrying the container structure."""
    arrays: Dict[str, np.ndarray] = {}
    entries: List[dict] = []

    for mkey, metric in metrics.items():
        sd = metric.state_dict()
        for name in metric._state_name_to_reduction:
            value = sd[name]
            entry: dict = {"metric": mkey, "state": name}
            mesh_shape = _sharded_mesh_shape(metric, name)
            if mesh_shape is not None:
                entry["sharded_mesh"] = mesh_shape
            if isinstance(value, deque):
                entry["kind"] = "deque"
                entry["maxlen"] = value.maxlen
                values = list(value)
            elif isinstance(value, list):
                entry["kind"] = "list"
                values = list(value)
            elif isinstance(value, dict):
                bad = [k for k in value if not isinstance(k, _JSON_KEY_TYPES)]
                if bad:
                    raise CheckpointError(
                        "unsupported",
                        f"dict state {name!r} of metric {mkey!r} has "
                        f"non-JSON-serialisable keys {bad!r}; checkpointing "
                        "requires str/int/float/bool dict keys.",
                    )
                entry["kind"] = "dict"
                entry["keys"] = list(value.keys())
                values = list(value.values())
            else:
                entry["kind"] = "array"
                values = [value]
            leaves, dtypes = [], []
            for v in values:
                key = f"a{len(arrays)}"
                arrays[key], dtype = _host_leaf(v)
                leaves.append(key)
                dtypes.append(dtype)
            entry["leaves"] = leaves
            if any(dtypes):
                # the JAX reader never reads this field
                entry["dtypes"] = [d or str(arrays[k].dtype) for k, d in zip(leaves, dtypes)]
            entries.append(entry)
    return arrays, entries


def _write_npz(path: str, arrays: Dict[str, np.ndarray], bf16: set) -> None:
    """``np.savez(path, **arrays)`` (the same members, uncompressed, the
    same ``.npy`` framing), except that the leaves named in ``bf16`` carry
    the descr ``'<V2'`` in their header, as the JAX package writes a
    bfloat16 leaf (numpy alone would write ``'|V2'``)."""
    fmt = np.lib.format
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for key, arr in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if key in bf16:
                    header = fmt.header_data_from_array_1_0(arr)
                    header["descr"] = _BF16_DESCR
                    fmt.write_array_header_1_0(f, header)
                    f.write(arr.tobytes())
                else:
                    fmt.write_array(f, arr, allow_pickle=False)


def _leaf_ok(entry: dict, i: int, leaf: np.ndarray) -> None:
    """Raise ``"unsupported"`` for a raw 2-byte leaf with no dtype named:
    the JAX package writes a bfloat16 leaf so, and records nothing else."""
    if leaf.dtype.kind != "V":
        return
    dtypes = entry.get("dtypes")
    named = dtypes[i] if isinstance(dtypes, list) and i < len(dtypes) else None
    if named == _BF16_NAME and leaf.dtype.itemsize == 2:
        return
    raise CheckpointError(
        "unsupported",
        f"state {entry['state']!r} of metric {entry['metric']!r} has a leaf of raw "
        f"type {leaf.dtype.str!r} and no dtype named for it (the JAX package writes "
        "a bfloat16 leaf so, and it cannot be restored bit for bit): cast the "
        "state to float32 before saving it there.",
    )


def _rebuild_state(entry: dict, payload, default) -> Any:
    """Inverse of one :func:`_flatten_states` entry, as host arrays, using
    the restore target's registered ``default`` to re-impose container
    semantics the wire format does not carry (defaultdict factories)."""
    try:
        leaves = [payload[k] for k in entry["leaves"]]
    except KeyError as e:
        raise CheckpointError(
            "corrupt_payload",
            f"payload is missing leaf {e} for state "
            f"{entry['state']!r} of metric {entry['metric']!r}.",
        ) from None
    for i, leaf in enumerate(leaves):
        _leaf_ok(entry, i, leaf)
    kind = entry["kind"]
    if kind == "array":
        return leaves[0]
    if kind == "list":
        return leaves
    if kind == "deque":
        return deque(leaves, maxlen=entry.get("maxlen"))
    if kind == "dict":
        out = dict(zip(entry["keys"], leaves))
        if isinstance(default, defaultdict) and default.default_factory:
            d = defaultdict(default.default_factory)
            d.update(out)
            return d
        if isinstance(default, dict):
            # mirror Metric.reset: plain-dict defaults get the reference's
            # missing-key-is-zero semantics after any wholesale state write
            from torcheval_tpu_torch.metrics.metric import _zero_scalar

            d = defaultdict(_zero_scalar)
            d.update(out)
            return d
        return out
    raise CheckpointError("corrupt_manifest", f"unknown state container kind {kind!r}.")


# --------------------------------------------------------------- dir layout
def _step_of(name: str) -> Optional[int]:
    if not name.startswith(_CKPT_PREFIX):
        return None
    try:
        return int(name[len(_CKPT_PREFIX):])
    except ValueError:
        return None


def list_checkpoints(directory: str) -> List[str]:
    """Published checkpoint paths under ``directory``, oldest first."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    steps = sorted(
        (s, n) for n in names if (s := _step_of(n)) is not None
    )
    return [os.path.join(directory, n) for _, n in steps]


def latest_checkpoint(directory: str) -> Optional[str]:
    """Newest published checkpoint path, or ``None``."""
    ckpts = list_checkpoints(directory)
    return ckpts[-1] if ckpts else None


def _manifest_readable(ckpt: str) -> bool:
    """``True`` when ``ckpt``'s manifest parses and carries every required
    field — the cheap validity probe (no payload scan) rotation and
    discovery use to avoid orphaning/hiding the last valid generation."""
    try:
        _read_manifest(ckpt)
    except CheckpointError:
        return False
    return True


def rotate_checkpoints(directory: str, keep_last: int) -> None:
    """Remove published checkpoints beyond the newest ``keep_last``.
    ``save(keep_last=)`` calls this after its durable publish; callers
    that must defer rotation past their own commit point call it directly
    afterwards.

    The last *valid* generation is never a victim: when none
    of the retained newest ``keep_last`` dirs has a readable manifest —
    every retained generation is torn or bit-rotted — the newest valid
    older generation is spared, so rotation can never leave a directory
    with zero restorable checkpoints. Quarantined ``corrupt-*`` dirs are
    invisible here by construction (they no longer parse as ``ckpt-*``)
    and are therefore never rotated away either.
    """
    ckpts = list_checkpoints(directory)
    victims = ckpts[:-keep_last]
    if victims and not any(_manifest_readable(c) for c in ckpts[-keep_last:]):
        for c in reversed(victims):
            if _manifest_readable(c):
                victims = [v for v in victims if v != c]
                _logger.warning(
                    "checkpoint rotation spared %s: it is the newest "
                    "generation with a readable manifest (every retained "
                    "newer generation is corrupt).",
                    c,
                )
                break
    for old in victims:
        shutil.rmtree(old, ignore_errors=True)


def discover_checkpoints(root: str) -> Dict[str, str]:
    """Map each immediate subdirectory of ``root`` that holds published
    checkpoints to its newest one: ``{name: ckpt_path}``.

    Checkpoint-root discovery: when each worker checkpoints into
    ``<root>/<name>``, this enumerates every recoverable one, and its
    resume point, from shared storage alone, with no word from any dead
    process. Subdirectories without a published ``ckpt-*`` (e.g. only
    ``.tmp-*`` left by a crash mid-save) are omitted.

    Hardened against bit rot: a generation whose ``manifest.json`` is
    unparseable or truncated is SKIPPED (counted into
    ``resilience.checkpoint.corrupt_skipped{reason=}``) and the next-older
    generation is offered instead, so one torn manifest never raises
    mid-discovery or hides another subdirectory's checkpoints. A
    subdirectory with no readable generation at all is omitted like an
    empty one.
    """
    out: Dict[str, str] = {}
    try:
        names = os.listdir(root)
    except (FileNotFoundError, NotADirectoryError):
        return out
    for name in sorted(names):
        sub = os.path.join(root, name)
        if not os.path.isdir(sub):
            continue
        for ckpt in reversed(list_checkpoints(sub)):
            try:
                _read_manifest(ckpt)
            except CheckpointError as e:
                _logger.warning(
                    "checkpoint discovery skipping %s (%s); trying the "
                    "previous generation.",
                    ckpt,
                    e.reason,
                )
                _obs.counter(
                    "resilience.checkpoint.corrupt_skipped",
                    reason=e.reason,
                )
                continue
            out[name] = ckpt
            break
    return out


_TMP_GC_MIN_AGE_S = 3600.0  # mtime fallback when the writer pid is unknowable


_TMP_NAME = re.compile(
    re.escape(_TMP_PREFIX) + re.escape(_CKPT_PREFIX) + r"\d+-(\d+)$"
)


def _tmp_writer_pid(name: str) -> Optional[int]:
    """The pid a ``.tmp-ckpt-<step>-<pid>`` name embeds, or ``None``.

    The FULL shape must match — a lax ``rsplit("-")`` would read a pid out
    of any foreign ``.tmp-*`` name whose last segment happens to be
    numeric (``.tmp-upload-123``) and, if that unrelated pid is not
    running, the GC would delete a concurrent tool's fresh data instead of
    applying the mtime-age fallback."""
    m = _TMP_NAME.match(name)
    return int(m.group(1)) if m else None


def _gc_stale_tmps(directory: str) -> int:
    """Remove ``.tmp-*`` directories orphaned by a writer that crashed
    between write and rename (they otherwise accumulate forever).

    Called after every durable publish. A tmp dir is stale when its
    embedded writer pid is provably dead (``os.kill(pid, 0)`` raises
    ``ProcessLookupError``) — a *live* writer's in-progress tmp, whatever
    its age, is never touched (its pid answers the probe; so does a
    same-pid process after pid reuse, which errs on the safe side). When
    the pid cannot be parsed (foreign tooling, truncated name), fall back
    to mtime: only dirs older than an hour are reclaimed, so a
    concurrent-looking fresh tmp survives. Returns the number removed."""
    removed = 0
    now = time.time()
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return 0
    for name in names:
        if not name.startswith(_TMP_PREFIX):
            continue
        path = os.path.join(directory, name)
        pid = _tmp_writer_pid(name)
        if pid == os.getpid():
            continue  # our own in-flight write (save() is re-entrant-safe)
        if pid is not None:
            try:
                os.kill(pid, 0)
                continue  # writer (or a pid-reuse doppelganger) is alive
            except ProcessLookupError:
                pass  # provably dead: the crash this GC exists for
            except OSError:
                continue  # EPERM etc.: a live process we cannot signal
        else:
            try:
                if now - os.path.getmtime(path) < _TMP_GC_MIN_AGE_S:
                    continue
            except OSError:
                continue
        shutil.rmtree(path, ignore_errors=True)
        removed += 1
    if removed:
        _logger.warning(
            "checkpoint: reclaimed %d stale .tmp-* dir(s) under %s "
            "(left by a writer that crashed mid-save).",
            removed,
            directory,
        )
        _obs.counter("resilience.checkpoint.tmp_gc", float(removed))
    return removed


def _fsync_file(path: str) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platform without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# --------------------------------------------------------------------- save
def save(
    obj: Any,
    directory: str,
    *,
    step: Optional[int] = None,
    keep_last: Optional[int] = None,
    extra: Optional[dict] = None,
) -> str:
    """Write one atomic checkpoint of ``obj`` under ``directory``.

    ``step`` defaults to one past the newest existing checkpoint. With
    ``keep_last=N``, older checkpoints beyond the newest ``N`` are removed
    after the new one is durably published (rotation can therefore never
    leave fewer than one complete checkpoint behind). ``extra`` is an
    optional JSON-serialisable dict stored in the manifest (readable back
    via :func:`read_extra`); it rides the same temp-then-rename publish and
    does not enter the schema digest. Returns the published checkpoint
    path. A slice-sharded collection's ``save`` is a collective over its
    slice group (module doc).
    """
    if keep_last is not None and keep_last < 1:
        # validate BEFORE any side effect: rejecting the argument after the
        # checkpoint has published would hand the caller an error plus a
        # checkpoint it did not expect to exist
        raise ValueError(f"keep_last must be >= 1, got {keep_last}.")
    metrics = _as_metrics(obj)
    for m in metrics.values():
        # capture the logical state: deferred pending batches fold first
        # (state_dict folds too; this keeps the contract explicit)
        m._fold_now()
    with _obs.span("resilience.checkpoint.save"):
        arrays, entries = _flatten_states(metrics)
        bf16 = {
            k for e in entries for k, d in zip(e["leaves"], e.get("dtypes", ())) if d == _BF16_NAME
        }
        os.makedirs(directory, exist_ok=True)
        if step is None:
            existing = [s for n in os.listdir(directory) if (s := _step_of(n)) is not None]
            step = (max(existing) + 1) if existing else 0
        final = os.path.join(directory, f"{_CKPT_PREFIX}{step:08d}")
        if os.path.exists(final):
            raise CheckpointError(
                "unsupported", f"checkpoint step {step} already exists at {final}."
            )
        tmp = os.path.join(directory, f"{_TMP_PREFIX}{_CKPT_PREFIX}{step:08d}-{os.getpid()}")
        os.makedirs(tmp)
        try:
            payload_path = os.path.join(tmp, _PAYLOAD)
            # exact bytes, uncompressed: the checksum (not zlib) is the
            # integrity mechanism
            _write_npz(payload_path, arrays, bf16)
            del arrays
            digest = hashlib.sha256()
            with open(payload_path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    digest.update(chunk)
            manifest = {
                "format_version": _FORMAT_VERSION,
                "step": step,
                "schema_digest": _schema_digest(metrics),
                "payload": _PAYLOAD,
                "payload_sha256": digest.hexdigest(),
                "payload_bytes": os.path.getsize(payload_path),
                "metrics": {k: type(m).__qualname__ for k, m in metrics.items()},
                "entries": entries,
            }
            if extra is not None:
                manifest["extra"] = extra
            manifest_path = os.path.join(tmp, _MANIFEST)
            with open(manifest_path, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_file(payload_path)
            _fsync_dir(tmp)
            # the atomic publish: a crash anywhere above leaves only a
            # .tmp-* directory, which no reader ever considers
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        _fsync_dir(directory)
    if _chaos.ckpt_armed():
        # test-only silent-bit-rot injection: flips one payload byte of the
        # generation just published, AFTER the durable publish; the
        # reader-side lineage fallback is what is under test
        _chaos.on_ckpt_saved(final)
    nbytes = manifest["payload_bytes"] + os.path.getsize(os.path.join(final, _MANIFEST))
    _obs.counter("resilience.checkpoint.saves")
    _obs.counter("resilience.checkpoint.bytes", float(nbytes))
    # timeline instant AT the durable publish (the save span covers the
    # whole write; this marks the os.replace moment a restore can rely on)
    _obs_trace.instant("resilience.checkpoint.published", kind="checkpoint", step=step, bytes=nbytes)
    if keep_last is not None:
        rotate_checkpoints(directory, keep_last)
    # reclaim tmp dirs orphaned by a crashed writer, AFTER the durable
    # publish, so a directory that only ever sees failing saves is never
    # mutated by the failures themselves
    _gc_stale_tmps(directory)
    return final


# ------------------------------------------------------------------ restore
def _read_manifest(ckpt: str) -> dict:
    manifest_path = os.path.join(ckpt, _MANIFEST)
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise CheckpointError(
            "not_found", f"no manifest at {manifest_path}."
        ) from None
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointError(
            "corrupt_manifest", f"unreadable manifest at {manifest_path}: {e}"
        ) from None
    for field in ("format_version", "schema_digest", "payload_sha256", "entries"):
        if field not in manifest:
            raise CheckpointError(
                "corrupt_manifest",
                f"manifest at {manifest_path} is missing {field!r}.",
            )
    if manifest["format_version"] != _FORMAT_VERSION:
        raise CheckpointError(
            "corrupt_manifest",
            f"unsupported checkpoint format_version "
            f"{manifest['format_version']} (this build reads {_FORMAT_VERSION}).",
        )
    return manifest


def _resolve_ckpt(path: str) -> str:
    """``path`` itself if it is a checkpoint directory, else the newest
    published ``ckpt-*`` under it. Raises ``not_found`` when neither."""
    if os.path.exists(os.path.join(path, _MANIFEST)):
        return path
    nested = latest_checkpoint(path)
    if nested is None:
        raise CheckpointError(
            "not_found", f"no checkpoint found under {path!r}."
        )
    return nested


def read_extra(path: str) -> dict:
    """The ``extra`` metadata dict :func:`save` stored in the manifest at
    ``path`` (a checkpoint directory, or a parent whose newest ``ckpt-*``
    is used); ``{}`` when none was stored. Validates the manifest shape
    (same :class:`CheckpointError` reasons as :func:`restore`) but not the
    payload checksum — reading a watermark must not cost a full payload
    scan."""
    manifest = _read_manifest(_resolve_ckpt(path))
    extra = manifest.get("extra", {})
    if not isinstance(extra, dict):
        raise CheckpointError(
            "corrupt_manifest",
            f"manifest 'extra' at {path!r} is {type(extra).__name__}, "
            "expected a dict.",
        )
    return extra


def _check_mesh_portability(entry: dict, metric, mkey: str) -> None:
    """Replicated state restores anywhere; a sliced state that was split
    over a slice group at save time (``sharded_mesh``) restores into a
    member sharded over an equal mesh dim (name and size), or into an
    unsharded member as the global value (the slice layout is block-range
    tiles of one leading axis, so the payload is mesh-independent). A
    member sharded any other way raises ``"unsupported"``: re-tiling onto a
    topology the saver never validated must be an explicit failure."""
    saved_mesh = entry.get("sharded_mesh")
    if saved_mesh is None:
        return
    shard = getattr(metric, "_shard", None)
    current = {str(shard.name): int(shard.size)} if shard is not None else None
    if current == dict(saved_mesh):
        return
    if current is None and getattr(metric, "_sliced_sync", False):
        return
    raise CheckpointError(
        "unsupported",
        f"state {entry['state']!r} of metric {mkey!r} was sharded "
        f"across mesh {dict(saved_mesh)!r} at save time but the "
        f"restore target's slice mesh is {current!r}: sharded state "
        "requires an equal mesh dim, or an unsharded target.",
    )


def _slots(value: Any):
    """``(container, key, leaf)`` for every host array of one rebuilt
    state, so placement can replace each leaf in place."""
    if isinstance(value, np.ndarray):
        yield None, None, value
    elif isinstance(value, (list, deque)):
        for i, v in enumerate(value):
            yield value, i, v
    elif isinstance(value, dict):
        for k, v in value.items():
            yield value, k, v


def _torch_dtype(leaf: np.ndarray) -> torch.dtype:
    """The tensor type of a host leaf; a raw 2-byte leaf that passed
    :func:`_leaf_ok` is bfloat16."""
    if leaf.dtype == _RAW2:
        return torch.bfloat16
    try:
        return torch.from_numpy(np.empty(0, leaf.dtype)).dtype
    except TypeError:
        raise CheckpointError(
            "unsupported", f"a leaf of type {leaf.dtype} has no torch counterpart."
        ) from None


def _host_tensor(leaf: np.ndarray) -> torch.Tensor:
    """A CPU tensor holding a copy of ``leaf`` (a read-only mapped view)."""
    own = np.array(leaf, order="C")
    if own.dtype == _RAW2:
        return torch.from_numpy(own.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(own)


def _place_restored(trees: Dict[str, Dict[str, Any]], metrics: Dict[str, Any]) -> None:
    """Replace every host leaf of ``trees`` with a tensor on its metric's
    device, in place. The leaves of one CUDA device cross in ONE
    non-blocking copy from ONE pinned staging buffer (each leaf at a
    64-byte aligned offset), then the stream is synchronised once; the
    tensors installed are views into that device buffer (each metric's
    ``load_state_dict`` copies them). CPU leaves are copied from the
    mapping. Any placement error raises: a restore never loads state
    somewhere other than where the metric lives."""
    by_device: Dict[torch.device, list] = {}
    for mkey, tree in trees.items():
        device = torch.device(metrics[mkey].device)
        for sname, value in tree.items():
            for container, key, leaf in _slots(value):
                slot = (tree, sname) if container is None else (container, key)
                if device.type == "cpu":
                    _torch_dtype(leaf)  # an unsupported type raises
                    slot[0][slot[1]] = _host_tensor(leaf)
                else:
                    by_device.setdefault(device, []).append((slot, leaf))
    for device, items in by_device.items():
        offsets, total = [], 0
        for _, leaf in items:
            offsets.append(total)
            total += -(-leaf.nbytes // _STAGE_ALIGN) * _STAGE_ALIGN
        staging = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
        host = staging.numpy()
        for (_, leaf), off in zip(items, offsets):
            flat = np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)
            host[off : off + flat.size] = flat
        placed = staging.to(device, non_blocking=True)
        torch.cuda.current_stream(device).synchronize()
        for ((container, key), leaf), off in zip(items, offsets):
            part = placed[off : off + leaf.nbytes]
            container[key] = part.view(_torch_dtype(leaf)).reshape(leaf.shape)


def restore(obj: Any, path: str) -> Any:
    """Restore ``obj``'s metric states from ``path``: a checkpoint
    directory, or a parent directory whose newest ``ckpt-*`` is used.

    Validation order: manifest parse, payload checksum, schema digest,
    payload decode (leaf shapes, raw types, mesh portability), placement.
    Any failure raises :class:`CheckpointError` *before* any metric state
    is written, so a failed restore never leaves ``obj`` half-loaded.
    Returns ``obj``.
    """
    metrics = _as_metrics(obj)
    ckpt = _resolve_ckpt(path)
    with _obs.span("resilience.checkpoint.restore"):
        manifest = _read_manifest(ckpt)
        payload_path = os.path.join(ckpt, manifest.get("payload", _PAYLOAD))
        digest = hashlib.sha256()
        try:
            with open(payload_path, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    digest.update(chunk)
        except OSError as e:
            raise CheckpointError(
                "corrupt_payload", f"unreadable payload {payload_path}: {e}"
            ) from None
        if digest.hexdigest() != manifest["payload_sha256"]:
            raise CheckpointError(
                "checksum_mismatch",
                f"payload {payload_path} does not match its manifest "
                f"checksum (expected {manifest['payload_sha256']}, got "
                f"{digest.hexdigest()}); refusing to load a torn or "
                "bit-rotted checkpoint.",
            )
        if _schema_digest(metrics) != list(manifest["schema_digest"]):
            raise CheckpointError(
                "schema_mismatch",
                f"checkpoint at {ckpt} was taken from a different metric "
                "set than the restore target (metric keys, classes, state "
                "names, reductions and fold-relevant configuration, e.g. "
                "windowed metrics' window_size, must all match; saved "
                f"metrics: {manifest.get('metrics')}).",
            )
        try:
            # the payload maps read-only and every aligned uncompressed leaf
            # decodes as a zero-copy view over the mapped pages
            payload_mm = np.memmap(payload_path, dtype=np.uint8, mode="r")
            payload = npz_views(payload_mm)
            trees: Dict[str, Dict[str, Any]] = {k: {} for k in metrics}
            for entry in manifest["entries"]:
                mkey, sname = entry["metric"], entry["state"]
                if mkey not in metrics:
                    raise CheckpointError(
                        "schema_mismatch", f"manifest names unknown metric {mkey!r}."
                    )
                _check_mesh_portability(entry, metrics[mkey], mkey)
                default = metrics[mkey]._state_name_to_default.get(sname)
                value = _rebuild_state(entry, payload, default)
                if (
                    entry["kind"] == "array"
                    and hasattr(default, "shape")
                    and tuple(value.shape) != tuple(default.shape)
                ):
                    # sliced states: the LEADING dim is the slice capacity
                    # (a sharded member's default holds one tile), which
                    # differs between a fresh member and a grown
                    # checkpoint; the member's load_state_dict re-derives
                    # the capacity and the id table from the restored
                    # lanes. Trailing dims must still match.
                    resizable = sname in getattr(metrics[mkey], "_lead_resizable_states", ())
                    if not (
                        resizable
                        and len(value.shape) == len(default.shape)
                        and tuple(value.shape[1:]) == tuple(default.shape[1:])
                    ):
                        # configuration drift the digest cannot see (e.g.
                        # macro accuracy's per-class counters under another
                        # num_classes)
                        raise CheckpointError(
                            "schema_mismatch",
                            f"state {sname!r} of metric {mkey!r} has shape "
                            f"{tuple(value.shape)} in the checkpoint but "
                            f"{tuple(default.shape)} in the restore target: "
                            "same metric schema, drifted configuration "
                            "(e.g. num_classes/num_tasks)?",
                        )
                trees[mkey][sname] = value
            _place_restored(trees, metrics)
        except NPZ_FORMAT_ERRORS as e:
            raise CheckpointError(
                "corrupt_payload", f"undecodable payload {payload_path}: {e}"
            ) from None
        del payload, payload_mm
        for mkey, tree in trees.items():
            metrics[mkey].load_state_dict(tree)
    _obs.counter("resilience.checkpoint.restores")
    _obs_trace.instant("resilience.checkpoint.restored", kind="checkpoint", step=manifest.get("step", -1))
    return obj


# --------------------------------------------------------- lineage fallback
# the CheckpointError reasons that mean THIS generation's bytes are bad
# (quarantine it and fall back to an older one) — as opposed to
# schema_mismatch/unsupported, which indict the restore TARGET's
# configuration and would fail identically against every generation
_CORRUPT_REASONS = frozenset(
    {"corrupt_manifest", "corrupt_payload", "checksum_mismatch"}
)


def quarantine_checkpoint(ckpt: str) -> Optional[str]:
    """Atomically rename a corrupt generation ``ckpt-<step>`` to
    ``corrupt-ckpt-<step>``: the bytes are preserved for
    forensics — counted, never deleted — while the dir stops parsing as a
    published checkpoint, so every reader (``list_checkpoints``, rotation,
    discovery) forgets it exists. ``corrupt-*``
    names are likewise invisible to the ``.tmp-*`` GC, so a quarantined
    generation outlives any amount of later save churn. Returns the new
    path, or ``None`` when the dir vanished underneath us (a concurrent
    reader already quarantined it — not an error)."""
    parent, name = os.path.split(os.path.normpath(ckpt))
    target = os.path.join(parent, _CORRUPT_PREFIX + name)
    suffix = 1
    while os.path.exists(target):
        suffix += 1
        target = os.path.join(parent, f"{_CORRUPT_PREFIX}{name}.{suffix}")
    try:
        os.rename(ckpt, target)
    except FileNotFoundError:
        return None
    _fsync_dir(parent)
    _logger.warning(
        "checkpoint: quarantined corrupt generation %s -> %s "
        "(preserved for forensics, excluded from every future restore).",
        ckpt,
        target,
    )
    _obs.counter("resilience.checkpoint.corrupt_quarantined")
    _obs_trace.instant(
        "resilience.checkpoint.quarantined", kind="checkpoint", path=target
    )
    return target


def restore_latest_valid(obj: Any, directory: str) -> str:
    """Restore ``obj`` from the newest *valid* generation under
    ``directory``, walking newest→oldest past corrupt ones.

    Each generation whose bytes fail validation (``corrupt_manifest`` /
    ``corrupt_payload`` / ``checksum_mismatch``) is quarantined via
    :func:`quarantine_checkpoint` and the walk continues — a bit-flipped
    newest checkpoint degrades the caller to the previous durable
    generation instead of failing the restore outright.
    ``schema_mismatch`` / ``unsupported`` raise immediately: they indict
    the restore target's configuration, not the checkpoint's bytes, and
    quarantining on them would destroy lineage a correctly-configured
    caller could still use. Raises ``CheckpointError("not_found")`` when
    no valid generation remains. Counts each successful restore that had
    to skip at least one corrupt generation into
    ``resilience.checkpoint.fallback_restores``. Returns the path of the
    generation actually restored."""
    skipped = 0
    while True:
        ckpt = latest_checkpoint(directory)
        if ckpt is None:
            raise CheckpointError(
                "not_found",
                f"no valid checkpoint generation remains under "
                f"{directory!r} ({skipped} corrupt generation(s) "
                "quarantined).",
            )
        try:
            restore(obj, ckpt)
        except CheckpointError as e:
            if e.reason not in _CORRUPT_REASONS:
                raise
            quarantine_checkpoint(ckpt)
            skipped += 1
            continue
        if skipped:
            _obs.counter("resilience.checkpoint.fallback_restores")
        return ckpt
