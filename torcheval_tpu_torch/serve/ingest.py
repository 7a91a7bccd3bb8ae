"""Pooled host staging buffers + coalesced H2D for the eval service.

JAX counterpart: ``torcheval_tpu/serve/ingest.py``. The host half (size
classes, the cooling rack, the shrink policy, shared stages) is the same;
the device half is Hopper's: pinned staging, one asynchronous copy a
signature group on a copy stream, and CUDA events as anchors.

* :class:`HostBufferPool` — size-classed, reusable host staging buffers.
  ``recv_frame_into`` reads each frame's payload straight into a pooled
  slot and ``unpack_tree`` decodes zero-copy views over it
  (``utils/npz.py``), so the steady ingest path performs no per-batch
  payload allocation at all. A pool that serves a CUDA device allocates
  its slots as **pinned** host memory (``torch.empty(..., pin_memory=True)``,
  exposed as a writable numpy view), so the copy engine reads them
  asynchronously; a pool for the CPU allocates plain memory. The pool's
  device decides, and a pin that fails on a CUDA pool raises. Pinning is
  slow (``cudaHostAlloc``), which is why the slots are reused.
* The **aliasing contract**: a released buffer is not recycled while
  anything that read it may still be in flight. ``release(anchor=...)``
  parks the slot in a cooling rack keyed by an anchor, and the slot only
  re-enters the free list once the anchor has retired. An anchor is a
  ``torch.cuda.Event`` recorded after the copy that read the slot (or a
  :func:`group_anchor` of several); its probe is ``event.query()``, and an
  error that probe raises propagates: it never frees the slot.
* :func:`coalesce_h2d` — ONE host-to-device copy per coalesced signature
  group per serving pass (the daemon's scheduler builds the groups). The
  group's unique host arrays are packed into one pinned staging slot, each
  at an offset padded to 256 bytes, and copied with one
  ``copy_(..., non_blocking=True)`` on the daemon's copy stream into one
  device buffer; the placed tensors are dtype views into it. The calling
  thread's current stream waits on the copy's event before anything it
  enqueues later, and the device buffer is ``record_stream``-ed on it.
  Identical host arrays (by object identity) transfer once and share one
  device view; such batches are reported ``owned=False`` so their chunks
  are never released early.

Observability: ``serve.ingest.pool{result=hit|miss|grow}`` counters on
every acquire, a ``serve.ingest.h2d_bytes`` counter and one
``serve.ingest.transfer`` timeline bar per coalesced transfer, and a
``serve.ingest.stage`` bar per pooled payload fill (emitted by the wire).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.obs import registry as _obs
from torcheval_tpu_torch.obs import trace as _trace
from torcheval_tpu_torch.utils.devices import DeviceLike, canonical_device

__all__ = [
    "HostBufferPool",
    "PooledBuffer",
    "SharedStage",
    "coalesce_h2d",
    "group_anchor",
]

_MIN_CLASS_BITS = 12  # smallest slot: 4 KiB
# every array's offset in a packed staging region (and so in the device
# buffer its views alias) is a multiple of this: a dtype view of a byte
# buffer must start at a multiple of its element size
_ALIGN = 256


def _size_class(nbytes: int) -> int:
    bits = max(int(nbytes - 1).bit_length(), _MIN_CLASS_BITS)
    return 1 << bits


class PooledBuffer:
    """One staging slot handed out by :class:`HostBufferPool`.

    ``view(n)`` exposes the first ``n`` bytes as a writable memoryview
    (the ``recv_into`` target and the npz-view backing store); ``tensor``
    is the same bytes as a ``uint8`` tensor (pinned on a CUDA pool).
    ``release(anchor=...)`` hands the slot back; it is idempotent — the
    first call wins, later calls are no-ops — so the ownership handoff
    between the wire handler and the daemon worker can be belt-and-braces
    on error paths without double-freeing."""

    __slots__ = ("pool", "nbytes", "tensor", "data", "_released", "_split")

    def __init__(self, pool: "HostBufferPool", nbytes: int) -> None:
        self.pool = pool
        self.nbytes = nbytes  # size class, not the payload length
        if pool.pinned:
            # no fallback: a CUDA pool whose pin fails raises here
            self.tensor = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self.data = self.tensor.numpy()
        else:
            self.data = np.empty(nbytes, dtype=np.uint8)
            self.tensor = torch.from_numpy(self.data)
        self._released = False
        self._split = False

    def view(self, n: int) -> memoryview:
        return memoryview(self.data)[:n]

    def release(self, *, anchor: Any = None) -> None:
        if self._released or self._split:
            # _split: ownership moved to a SharedStage's holders — only
            # the LAST share may free the slot, via _release_from_split
            # (a direct release here is the wire's belt-and-braces error
            # path firing late, and must never bypass the shares'
            # accumulated anchors)
            return
        self._released = True
        self.pool._release(self, anchor)

    def _release_from_split(self, anchor: Any) -> None:
        """The SharedStage-only release: frees the slot regardless of the
        ``_split`` latch (which stays set until the pool recycles the
        slot, so a racing direct ``release()`` can never free it with the
        shares' anchors discarded)."""
        if self._released:
            return
        self._released = True
        self.pool._release(self, anchor)

    @property
    def released(self) -> bool:
        return self._released


class _GroupAnchor:
    """Composite anchor: retired only when EVERY member anchor is."""

    __slots__ = ("anchors",)

    def __init__(self, anchors: List[Any]) -> None:
        self.anchors = anchors

    def is_ready(self) -> bool:
        return all(_anchor_retired(a) for a in self.anchors)


def group_anchor(anchors) -> _GroupAnchor:
    """An anchor that retires only when every anchor in ``anchors`` has."""
    return _GroupAnchor(list(anchors))


class SharedStage:
    """Reference-shared ownership of one :class:`PooledBuffer` backing
    SEVERAL queued batches (the coalesced ``submit_many`` frame): each
    holder's ``release`` drops one share and contributes its anchor; the
    slot frees when the last share goes, guarded by ALL contributed
    anchors (one frame's batches can ride different coalesced transfers
    — the earliest-released group's transfer may still be in flight when
    the last share drops). Individual releases stay idempotent-per-holder
    by the daemon's one-release-per-queue-entry discipline."""

    __slots__ = ("_stage", "_lock", "_n", "_anchors")

    def __init__(self, stage: PooledBuffer, n: int) -> None:
        self._stage = stage
        self._lock = threading.Lock()
        self._n = n
        self._anchors: List[Any] = []
        stage._split = True

    def release(self, *, anchor: Any = None) -> None:
        with self._lock:
            if anchor is not None:
                self._anchors.append(anchor)
            self._n -= 1
            if self._n != 0:
                return
            anchors = self._anchors
        final = (
            None
            if not anchors
            else anchors[0] if len(anchors) == 1 else _GroupAnchor(anchors)
        )
        # _split stays latched: a concurrent direct release() between a
        # cleared latch and this call would free the slot with the
        # accumulated anchors discarded
        self._stage._release_from_split(final)

    @property
    def released(self) -> bool:
        return self._stage.released


def _anchor_retired(anchor: Any) -> bool:
    """True when the work ``anchor`` marks (a copy that read host memory)
    has finished. A ``torch.cuda.Event`` answers through ``query()``,
    which never blocks; an error it raises (a failed device) propagates —
    there is no donation in this package that would make a raising probe
    mean "retired", so a slot is never freed on one."""
    if anchor is None:
        return True
    if isinstance(anchor, torch.cuda.Event):
        return bool(anchor.query())
    return bool(anchor.is_ready())


class HostBufferPool:
    """Size-classed reusable host staging buffers (module doc).

    ``device`` is the device the staged bytes are copied to: ``None``
    means ``cuda:0`` (and raises without CUDA), a CUDA device makes every
    slot pinned, ``"cpu"`` plain. ``max_slots_per_class`` bounds the FREE
    list per class (in-flight and cooling slots are unbounded —
    backpressure for those is the daemon's queue bound, not the pool's);
    ``idle_ttl_s`` drops free slots that have not been reused for that
    long, so a burst does not pin its peak footprint forever
    (:meth:`shrink` runs opportunistically on acquire). Thread-safe: wire
    handler threads acquire, the daemon worker releases.
    """

    def __init__(
        self,
        *,
        device: DeviceLike = None,
        max_slots_per_class: int = 8,
        idle_ttl_s: float = 30.0,
    ) -> None:
        self.device = canonical_device(device)
        self.pinned = self.device.type == "cuda"
        self._lock = threading.Lock()
        # size class -> [(buffer, freed_at)] free slots, LIFO for warmth
        self._free: Dict[int, List[Tuple[PooledBuffer, float]]] = {}
        # [(buffer, anchor)] released slots whose reader may be in flight
        self._cooling: List[Tuple[PooledBuffer, Any]] = []
        self._max_slots = max_slots_per_class
        self._idle_ttl_s = idle_ttl_s
        self._last_shrink = 0.0
        self.allocated = 0  # lifetime allocations (tests/ops visibility)

    def acquire(self, nbytes: int) -> PooledBuffer:
        """A staging slot of at least ``nbytes``. Recycles a retired slot
        when one exists (``result=hit``); otherwise allocates — counted as
        ``grow`` when slots of the class exist but are all still in
        flight (the double-buffering case: window N holds the pool's
        warm slot, window N+1 must come from a fresh one), ``miss`` on
        first sight of the class."""
        cls = _size_class(nbytes)
        now = time.monotonic()
        with self._lock:
            self._sweep_cooling_locked()
            free = self._free.get(cls)
            if free:
                buf, _t = free.pop()
                buf._released = False
                buf._split = False  # the split latch dies with the cycle
                result = "hit"
            else:
                in_flight = any(b.nbytes == cls for b, _a in self._cooling)
                result = "grow" if in_flight else "miss"
                buf = PooledBuffer(self, cls)
                self.allocated += 1
            if now - self._last_shrink >= 1.0:
                self._last_shrink = now
                self._shrink_locked(now)
        if _obs._enabled:
            _obs.counter("serve.ingest.pool", result=result)
        return buf

    def _release(self, buf: PooledBuffer, anchor: Any) -> None:
        with self._lock:
            if anchor is not None and not _anchor_retired(anchor):
                self._cooling.append((buf, anchor))
                return
            self._free_locked(buf, time.monotonic())

    def _free_locked(self, buf: PooledBuffer, now: float) -> None:
        free = self._free.setdefault(buf.nbytes, [])
        if len(free) < self._max_slots:
            free.append((buf, now))
        # over the cap: drop the buffer on the floor (plain GC)

    def _sweep_cooling_locked(self) -> None:
        if not self._cooling:
            return
        now = time.monotonic()
        still = []
        for buf, anchor in self._cooling:
            if _anchor_retired(anchor):
                self._free_locked(buf, now)
            else:
                still.append((buf, anchor))
        self._cooling = still

    def _shrink_locked(self, now: float) -> None:
        for cls, free in list(self._free.items()):
            kept = [(b, t) for b, t in free if now - t < self._idle_ttl_s]
            if kept:
                self._free[cls] = kept
            else:
                del self._free[cls]

    def shrink(self, *, now: Optional[float] = None) -> None:
        """Drop free slots idle past ``idle_ttl_s`` (also runs
        opportunistically on acquire, at most once a second)."""
        with self._lock:
            self._sweep_cooling_locked()
            self._shrink_locked(time.monotonic() if now is None else now)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "free": sum(len(v) for v in self._free.values()),
                "cooling": len(self._cooling),
                "allocated": self.allocated,
            }


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    """The torch dtype of ``dtype`` in native byte order (the packed copy
    is native: ``_pack`` swaps a foreign-order array while copying)."""
    return torch.from_numpy(np.empty(0, dtype=dtype.newbyteorder("="))).dtype


def _pack(order: Sequence[np.ndarray], base: np.ndarray) -> List[Tuple[int, int]]:
    """Copy each array of ``order`` into ``base`` (a byte buffer) at an
    offset padded to :data:`_ALIGN`; returns each ``(offset, nbytes)``."""
    spans = []
    off = 0
    for a in order:
        n = int(a.nbytes)
        if n:
            dst = base[off : off + n].view(a.dtype.newbyteorder("=")).reshape(a.shape)
            np.copyto(dst, a, casting="no" if a.dtype.isnative else "equiv")
        spans.append((off, n))
        off += -(-n // _ALIGN) * _ALIGN
    return spans


def _packed_size(order: Sequence[np.ndarray]) -> int:
    return sum(-(-int(a.nbytes) // _ALIGN) * _ALIGN for a in order)


def coalesce_h2d(
    batches: Sequence[Tuple[np.ndarray, ...]],
    device: DeviceLike = None,
    *,
    pool: Optional[HostBufferPool] = None,
    stream: Optional["torch.cuda.Stream"] = None,
) -> Tuple[List[Tuple[torch.Tensor, ...]], List[bool], Any]:
    """Place every host batch in ``batches`` (tuples of numpy arrays, one
    signature group) on ``device`` in ONE copy. Returns ``(placed_batches,
    owned_flags, anchor)``: per input batch, the tensor tuple and whether
    every one of its tensors is exclusively that batch's (identical host
    arrays transfer once and share one view — such a batch reports
    ``owned=False``); and the anchor a host buffer the arrays were read
    from must be released on (module doc): the copy's event on CUDA,
    ``None`` on the CPU, where the copy has finished on return.

    On CUDA the arrays are packed into one pinned slot of ``pool`` (a
    :class:`HostBufferPool` for ``device``; a one-off pool without one),
    copied asynchronously on ``stream`` (the current stream without one),
    and the caller's current stream waits on the copy before its later
    work. A failed pin or copy raises."""
    device = canonical_device(device)
    unique: Dict[int, int] = {}
    uses: Dict[int, int] = {}
    order: List[np.ndarray] = []
    for args in batches:
        for a in args:
            key = id(a)
            if key not in unique:
                unique[key] = len(order)
                order.append(a)
            uses[key] = uses.get(key, 0) + 1
    t0 = time.perf_counter()
    total = _packed_size(order)
    anchor: Any = None
    if device.type == "cuda":
        stage = (pool if pool is not None else HostBufferPool(device=device)).acquire(max(total, 1))
        host = stage.tensor
        try:
            spans = _pack(order, host.numpy())
            consumer = torch.cuda.current_stream(device)
            copy_stream = stream if stream is not None else consumer
            with torch.cuda.stream(copy_stream):
                buf = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
                buf.copy_(host[: max(total, 1)], non_blocking=True)
                anchor = torch.cuda.Event()
                anchor.record(copy_stream)
            if copy_stream is not consumer:
                consumer.wait_event(anchor)
                # the buffer was allocated on the copy stream: its memory
                # must not be handed out again before the consumer's work
                buf.record_stream(consumer)
        finally:
            stage.release(anchor=anchor)
    else:
        buf = torch.empty(max(total, 1), dtype=torch.uint8)
        spans = _pack(order, buf.numpy())
    placed = [
        buf[off : off + n].view(_torch_dtype(a.dtype)).view(a.shape)
        for a, (off, n) in zip(order, spans)
    ]
    nbytes = sum(n for _off, n in spans)
    if _obs._enabled:
        _obs.counter("serve.ingest.h2d_bytes", float(nbytes))
        _trace.complete(
            "serve.ingest.transfer",
            t0,
            time.perf_counter() - t0,
            kind="serve",
            bytes=nbytes,
            arrays=len(order),
            batches=len(batches),
        )
    out: List[Tuple[torch.Tensor, ...]] = []
    owned: List[bool] = []
    for args in batches:
        out.append(tuple(placed[unique[id(a)]] for a in args))
        owned.append(all(uses[id(a)] == 1 for a in args))
    return out, owned, anchor
