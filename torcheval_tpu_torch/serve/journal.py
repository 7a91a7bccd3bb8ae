"""``serve.journal``: the router's durable control-plane log.

JAX counterpart: ``torcheval_tpu/serve/journal.py``. The on-disk format
is that module's byte for byte (the same CRC32-framed JSON lines, the same
snapshot file), so a journal either package writes replays in the other.

The :class:`~torcheval_tpu_torch.serve.router.EvalRouter` holds the fleet's
tenant directory — placements, split fan-out topology, host membership —
only in memory. This module makes that state survive a router crash
without putting an fsync on the data path's hot loop:

* **WAL** (``wal.log``): one CRC32-framed JSON line per control-plane
  mutation (place, remove, move, split, host add/remove), ``fsync``'d
  before :meth:`RouterJournal.append` returns. Control-plane ops are
  rare (human/rebalancer timescale), so the per-record fsync is free
  where it matters; submits never touch the journal — the reconciliation
  pass recovers seq watermarks from the hosts themselves.
* **Snapshot compaction** (``snapshot.json``): the full routing table,
  written temp-then-``os.replace`` so a crash mid-compaction leaves the
  previous snapshot intact. Every record carries a monotonically
  increasing ``seq`` and the snapshot stamps the highest seq it folded
  in (``last_seq``), so the crash window *between* publishing a snapshot
  and truncating the WAL replays exactly once: replay skips WAL records
  at or below the snapshot watermark.
* **Torn-tail tolerance**: a process killed mid-``write`` leaves a
  truncated or garbled final record. Replay verifies each line's CRC and
  stops at the first bad one — dropped and counted
  (``serve.router.journal_torn_tails``), never a crash. Everything
  before the tear is intact (records are appended and fsync'd strictly
  in order).

Obs counters: ``serve.router.journal_records`` (appends),
``serve.router.journal_compactions``, ``serve.router.journal_torn_tails``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

from torcheval_tpu_torch.obs import registry as _obs

_logger = logging.getLogger(__name__)

_WAL = "wal.log"
_SNAPSHOT = "snapshot.json"


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platform without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _frame(record: Dict[str, Any]) -> bytes:
    body = json.dumps(record, sort_keys=True, separators=(",", ":")).encode(
        "utf-8"
    )
    return b"%08x %s\n" % (zlib.crc32(body) & 0xFFFFFFFF, body)


def _parse_line(line: bytes) -> Optional[Dict[str, Any]]:
    """One framed record, or ``None`` for a torn/corrupt line."""
    if not line.endswith(b"\n"):
        return None  # truncated mid-write: the torn tail itself
    head, sep, body = line[:-1].partition(b" ")
    if not sep or len(head) != 8:
        return None
    try:
        want = int(head, 16)
    except ValueError:
        return None
    if zlib.crc32(body) & 0xFFFFFFFF != want:
        return None
    try:
        record = json.loads(body)
    except ValueError:
        return None  # CRC'd garbage cannot happen, but never crash here
    return record if isinstance(record, dict) else None


class RouterJournal:
    """Append-only fsync'd WAL + snapshot compaction for router state.

    ``snapshot_fn`` (optional) returns the caller's full state dict; when
    set, :meth:`append` auto-compacts after ``compact_every`` records so
    the WAL stays bounded without the router scheduling anything. The
    callback runs on the appending thread — the router passes a bound
    method and already holds its own re-entrant lock there.
    """

    def __init__(
        self,
        directory: str,
        *,
        snapshot_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        compact_every: int = 256,
    ) -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._snapshot_fn = snapshot_fn
        self._compact_every = max(int(compact_every), 1)
        self._lock = threading.Lock()
        self._closed = False
        self._wal_path = os.path.join(self.directory, _WAL)
        snapshot, records, next_seq, good_bytes = self._load()
        self._seq = next_seq  # next record seq to assign
        self._since_compaction = len(records)
        self._wal = open(self._wal_path, "ab")
        if self._wal.tell() != good_bytes:
            # a torn tail was dropped at replay: cut the file back to the
            # last good record, or the next append would glue itself onto
            # the garbage and be dropped with it at the NEXT replay
            self._wal.truncate(good_bytes)
            self._wal.seek(good_bytes)
            os.fsync(self._wal.fileno())

    # ------------------------------------------------------------------ read
    def _load(
        self,
    ) -> Tuple[Optional[Dict[str, Any]], List[Dict[str, Any]], int, int]:
        """(snapshot state, live WAL records, next seq, good WAL bytes)
        from disk. ``good bytes`` is the offset of the first torn/corrupt
        record — the constructor truncates the WAL back to it."""
        snapshot: Optional[Dict[str, Any]] = None
        snap_seq = 0
        snap_path = os.path.join(self.directory, _SNAPSHOT)
        try:
            with open(snap_path, "rb") as f:
                loaded = json.loads(f.read().decode("utf-8"))
            if isinstance(loaded, dict) and isinstance(
                loaded.get("state"), dict
            ):
                snapshot = loaded["state"]
                snap_seq = int(loaded.get("last_seq", 0))
        except FileNotFoundError:
            pass
        except (OSError, ValueError, TypeError):
            # snapshots publish atomically, so a bad one is disk rot, not
            # a torn write; reconciliation against live hosts re-derives
            # what the snapshot held — degrade, never crash
            _logger.error(
                "router journal: unreadable snapshot %s; recovering from "
                "the WAL and live-host reconciliation only.",
                snap_path,
            )
            _obs.counter("serve.router.journal_torn_tails", reason="snapshot")
        records: List[Dict[str, Any]] = []
        last_seq = snap_seq
        good_bytes = 0
        try:
            with open(self._wal_path, "rb") as f:
                lines = f.readlines()
        except FileNotFoundError:
            lines = []
        for i, line in enumerate(lines):
            record = _parse_line(line)
            if record is None:
                # the torn tail: drop this record and (defensively)
                # anything after it — order is the journal's one
                # integrity guarantee, so nothing past a tear is trusted
                dropped = len(lines) - i
                _logger.warning(
                    "router journal: torn/corrupt record at line %d of "
                    "%s; dropped %d record(s) after the last good one.",
                    i + 1,
                    _WAL,
                    dropped,
                )
                _obs.counter("serve.router.journal_torn_tails", reason="wal")
                break
            good_bytes += len(line)
            seq = int(record.get("seq", 0))
            last_seq = max(last_seq, seq)
            if seq <= snap_seq:
                # folded into the snapshot already (crash between snapshot
                # publish and WAL truncation): skip, exactly-once replay
                continue
            records.append(record)
        self._last_loaded = (snapshot, records)
        return snapshot, records, last_seq + 1, good_bytes

    def replay(
        self,
    ) -> Tuple[Optional[Dict[str, Any]], List[Dict[str, Any]]]:
        """The durable history: (compacted state or None, ordered WAL
        records newer than it). Reflects disk at construction time —
        :class:`RouterJournal` is a single-writer log, so the constructor
        read is authoritative for the recovering process."""
        return self._last_loaded

    # ----------------------------------------------------------------- write
    def append(self, kind: str, **fields: Any) -> int:
        """Durably append one control-plane record; returns its seq.
        The record is on disk (fsync) when this returns — a router crash
        immediately after cannot lose it."""
        with self._lock:
            if self._closed:
                raise ValueError("RouterJournal is closed.")
            seq = self._seq
            self._seq += 1
            record = {"seq": seq, "kind": str(kind), **fields}
            self._wal.write(_frame(record))
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._since_compaction += 1
            _obs.counter("serve.router.journal_records", kind=str(kind))
            should_compact = (
                self._snapshot_fn is not None
                and self._since_compaction >= self._compact_every
            )
        if should_compact:
            self.compact(self._snapshot_fn())
        return seq

    def compact(self, state: Dict[str, Any]) -> None:
        """Publish ``state`` as the new snapshot (temp-then-replace) and
        truncate the WAL. Crash-safe at every point: before the replace
        the old snapshot + full WAL stand; between the replace and the
        truncation, replay skips WAL records the snapshot already folded
        in (seq watermark)."""
        with self._lock:
            if self._closed:
                raise ValueError("RouterJournal is closed.")
            last_seq = self._seq - 1
            snap_path = os.path.join(self.directory, _SNAPSHOT)
            tmp = snap_path + ".tmp"
            body = json.dumps(
                {"format_version": 1, "last_seq": last_seq, "state": state},
                sort_keys=True,
            ).encode("utf-8")
            with open(tmp, "wb") as f:
                f.write(body)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, snap_path)
            _fsync_dir(self.directory)
            # now safe to drop the WAL: everything in it is <= last_seq
            self._wal.close()
            self._wal = open(self._wal_path, "wb")
            self._since_compaction = 0
            _obs.counter("serve.router.journal_compactions")

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._wal.flush()
                os.fsync(self._wal.fileno())
            except (OSError, ValueError):
                pass
            self._wal.close()
