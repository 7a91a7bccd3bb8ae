"""`EvalClient`: the producer-side endpoint of the eval wire.

JAX counterpart: ``torcheval_tpu/serve/client.py``, ported whole. The
client touches no device: it speaks the wire the JAX package speaks, so it
drives a server of either package (tensors it is given are read back to
numpy before they are framed).

One client speaks to ONE host (an :class:`~torcheval_tpu_torch.serve.EvalServer`
in front of an :class:`~torcheval_tpu_torch.serve.EvalDaemon`); the cluster
router (``serve/router.py``) composes one client per endpoint. The client
owns every *unreliable-network* concern so callers see the same
structured-error surface a local :class:`TenantHandle` gives:

* **per-request deadlines** — every request runs under a socket timeout
  (``request_timeout_s`` default, overridable per call), validated at the
  boundary by the same ``_check_timeout_s`` every serve/sync deadline
  knob uses;
* **retry with exponential backoff + jitter** — transport failures and
  *retryable* structured errors (a shed, a capacity reject: the shared
  ``retryable`` classification from ``serve/errors.py``) retry up to
  ``max_attempts`` with the ``init_from_env`` backoff shape (×2 growth,
  cap, 0.5–1.5× jitter); non-retryable errors surface immediately;
* **a per-host circuit breaker** — ``breaker_threshold`` consecutive
  transport failures open the circuit and further calls fail fast with
  ``WireError("circuit_open")`` (no socket touched) until
  ``breaker_reset_s`` elapses and a half-open probe is allowed through;
* **bounded in-flight** — at most ``max_in_flight`` requests on the wire
  at once (a semaphore over the connection pool): client-side
  backpressure composes with the daemon's queue bounds instead of hiding
  them;
* **idempotent submits + a bounded replay buffer** — each submit carries
  a per-tenant monotonic ``seq`` and is held in a bounded replay buffer
  until an ack reports it *durable* (covered by a published checkpoint).
  A resend after an ambiguous failure is deduplicated server-side, so
  blind retries are safe; when the buffer fills, the client issues a
  ``flush`` (checkpoint-without-evicting) to advance the durable
  watermark and prune. The router migrates a dead host's tenants by
  restoring their checkpoints elsewhere and replaying exactly this
  buffer's un-durable tail;
* **deferred-ack pipelining** — with ``pipeline_depth > 1``
  (and a server that granted it at attach), submits stream on a
  dedicated channel socket up to that many frames ahead of their acks,
  so producer throughput is bounded by bandwidth instead of round-trip
  latency. Exactly-once needs no new client invariants: every streamed
  frame is already booked in the replay buffer, acks ride back
  asynchronously carrying the same ``acked_seq`` watermark, and any
  failure (error ack, dead channel, timeout) flags the existing
  ``needs_resend`` catch-up — the lock-step replay path settles
  delivery. The server admits pipelined frames *gaplessly* (a seq past
  a shed hole is rejected retryably), so the dedup watermark can never
  ratchet over an unapplied batch. Old servers never grant, so mixed
  versions silently run lock-step — degrade, never break;
* **shared-memory local transport** — when the server lives
  in this process, ``submit``/``submit_many`` payloads are handed to it
  directly: the staging-pool slot (or the immutable payload bytes) IS
  the buffer the daemon's zero-copy npz views decode from, skipping
  the socket write+read copy pair. Byte-identical semantics to TCP
  (same dispatch, same structured errors); TCP is the automatic
  fallback the moment the endpoint is not locally registered.
"""

from __future__ import annotations

import random
import socket
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.obs import registry as _obs
from torcheval_tpu_torch.serve.errors import ServeError, WireError
from torcheval_tpu_torch.serve.wire import (
    decode_error,
    local_server,
    pack_tree,
    pack_tree_parts,
    recv_frame,
    send_frame,
    send_frame_parts,
    unpack_tree,
)

__all__ = ["EvalClient", "ObsSubscription", "metric_spec"]

_UNSET = object()


def _host_array(a: Any) -> np.ndarray:
    """A submit argument as a host numpy array (a tensor on the card is
    read back)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a)


def metric_spec(class_name: str, **kwargs: Any) -> List[Any]:
    """One wire metric-spec entry: ``metric_spec("MulticlassAccuracy",
    num_classes=10)``. Class names resolve server-side against
    ``torcheval_tpu_torch.metrics`` only."""
    return [class_name, kwargs]


class _ClientTenant:
    """Client-side per-tenant wire state (sequence numbers + replay)."""

    __slots__ = (
        "lock",
        "next_seq",
        "durable_seq",
        "replay",
        "sendbuf",
        "migrated",
        "needs_resend",
        "codec",
    )

    def __init__(self, last_seq: int, codec: str = "raw") -> None:
        self.lock = threading.Lock()
        # the payload codec negotiated for this tenant at attach ("raw"
        # when the server accepted none): drives every submit/replay pack
        self.codec = codec
        self.next_seq = last_seq + 1
        self.durable_seq = last_seq
        self.replay: deque = deque()  # (seq, np-args tuple), seq ascending
        # booked-but-unsent tail under submit_buffer coalescing: every
        # entry here is ALSO in replay (booked at submit time), so a
        # crash/migration between booking and the coalesced send loses
        # nothing — the replay path delivers it
        self.sendbuf: list = []
        # set (under lock) by export_tenant: a concurrent submitter that
        # grabbed this state object before the export must NOT book a
        # batch into it — the buffer has already been carried elsewhere
        self.migrated = False
        # set when a booked submit escaped with a transport failure: the
        # next submit/flush must re-deliver the booked tail FIRST (dedup
        # absorbs any that actually landed) — otherwise a later batch
        # advances the daemon watermark past the hole and a flush prunes
        # the never-applied entry as "durable"
        self.needs_resend = False


class ObsSubscription:
    """One live obs stream from a host (``EvalClient.subscribe_obs``).

    ``mode`` is ``"push"`` when the server speaks the push
    channel (a dedicated socket outside the request pool carries
    ``obs_push`` frames on the server's timer) or ``"poll"`` when the
    peer rejected the op structurally — an OLD server — and the
    subscription degraded to calling ``health()`` on the same cadence
    (mixed versions degrade, never break). Either way ``on_push`` fires
    with one message dict per tick and :attr:`last` holds the newest;
    push messages carry ``delta`` + ``load_report``, poll messages carry
    ``load_report`` + the full ``health`` dict (no delta — polling has
    no cursor). ``stop()`` is idempotent and joins the reader thread."""

    def __init__(
        self,
        endpoint: str,
        interval_s: float,
        on_push: Optional[Any] = None,
    ) -> None:
        self.endpoint = endpoint
        self.interval_s = interval_s
        self.mode: Optional[str] = None
        self.last: Optional[Dict[str, Any]] = None
        self.last_at: Optional[float] = None
        self.received = 0
        self._on_push = on_push
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def alive(self) -> bool:
        """True while the reader/poller thread runs (a dead host ends a
        push subscription; a poll subscription keeps trying)."""
        return self._thread is not None and self._thread.is_alive()

    def _record(self, msg: Dict[str, Any]) -> None:
        self.last = msg
        self.last_at = time.monotonic()
        self.received += 1
        if self._on_push is not None:
            try:
                self._on_push(msg)
            except Exception:  # noqa: BLE001 - a bad callback can't kill
                pass  # the stream; next tick still delivers

    def stop(self) -> None:
        self._stop.set()
        sock = self._sock
        if sock is not None:
            # the push reader blocks in recv: severing the socket wakes it
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)


class _PipelinedChannel:
    """One deferred-ack submit stream to a host.

    A dedicated socket (outside the request pool) carries up to
    ``depth`` un-acked ``submit``/``submit_many`` frames; a reader
    thread parks each ack under the channel condition and holders of a
    TENANT's state lock fold their own parked acks in
    (:meth:`fold_locked`). The reader never takes a tenant lock, so the
    ack path and the submit path have no lock-order coupling — a
    submitter blocked on the window cannot deadlock the reader that
    would free it.

    Failure model: any socket error, EOF, or window-wait timeout kills
    the WHOLE channel (``_fail``) — every tenant with frames still in
    flight is marked dirty and folds into ``needs_resend`` on its next
    ``fold_locked``, after which the lock-step replay path settles
    delivery exactly-once (server-side gapless admission guarantees the
    dedup watermark never passed the hole). The owning client just
    opens a fresh channel on the next submit.
    """

    def __init__(
        self, sock: socket.socket, depth: int, endpoint: str
    ) -> None:
        self._sock = sock
        self.depth = depth
        self.endpoint = endpoint
        self._cv = threading.Condition()
        self._send_lock = threading.Lock()
        # (tenant_id, seq-tuple) -> True for every streamed, un-acked
        # frame; the dict size is the window occupancy
        self._inflight: Dict[Tuple[str, tuple], bool] = {}
        # tenant_id -> parked ack headers, folded by state.lock holders
        self._pending: Dict[str, List[Dict[str, Any]]] = {}
        self._dead: Optional[BaseException] = None
        # tenants that had frames in flight when the channel died: their
        # next fold flags needs_resend
        self._dirty: set = set()
        self._reader = threading.Thread(
            target=self._read_loop,
            name="torcheval-tpu-pipeline-acks",
            daemon=True,
        )
        self._reader.start()

    @property
    def alive(self) -> bool:
        with self._cv:
            return self._dead is None

    # ---------------------------------------------------------- reader side
    def _read_loop(self) -> None:
        while True:
            try:
                frame = recv_frame(self._sock)
            except (OSError, WireError) as e:
                self._fail(e)
                return
            if frame is None:
                self._fail(
                    WireError(
                        "transport",
                        f"{self.endpoint} closed the pipeline channel.",
                        endpoint=self.endpoint,
                    )
                )
                return
            header, _payload = frame
            tenant = str(header.get("tenant"))
            seqs = header.get("seqs")
            if seqs is None:
                seqs = [header.get("seq")]
            try:
                key = (tenant, tuple(int(s) for s in seqs))
            except (TypeError, ValueError):
                key = (tenant, ())
            with self._cv:
                self._inflight.pop(key, None)
                self._pending.setdefault(tenant, []).append(header)
                self._cv.notify_all()

    def _fail(self, exc: BaseException) -> None:
        with self._cv:
            self._fail_locked(exc)
        try:
            self._sock.close()
        except OSError:
            pass

    def _fail_locked(self, exc: BaseException) -> None:
        if self._dead is None:
            self._dead = exc
        for tenant, _seqs in self._inflight:
            self._dirty.add(tenant)
        self._inflight.clear()
        self._cv.notify_all()
        try:
            # wake the reader if it is parked in recv
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    # -------------------------------------------------------- tenant folding
    @staticmethod
    def _fold_acks(
        state: "_ClientTenant", acks: List[Dict[str, Any]], dirty: bool
    ) -> None:
        for header in acks:
            if header.get("ok"):
                state.durable_seq = max(
                    state.durable_seq, int(header.get("acked_seq", 0))
                )
            else:
                # a structured reject mid-pipeline: the frame's batches
                # (and, through gapless admission, everything streamed
                # after them) stay booked — lock-step replay settles it
                state.needs_resend = True
        if dirty:
            state.needs_resend = True
        while state.replay and state.replay[0][0] <= state.durable_seq:
            state.replay.popleft()

    def fold_locked(self, tenant_id: str, state: "_ClientTenant") -> None:
        """Fold this tenant's parked acks into its wire state (caller
        holds ``state.lock``). Never raises and never blocks on the
        socket: an error ack or a dead channel just flags
        ``needs_resend`` for the caller's catch-up path."""
        with self._cv:
            acks = self._pending.pop(tenant_id, [])
            dirty = tenant_id in self._dirty
            self._dirty.discard(tenant_id)
        self._fold_acks(state, acks, dirty)

    # ---------------------------------------------------------- submit side
    def send(
        self,
        tenant_id: str,
        state: "_ClientTenant",
        header: Dict[str, Any],
        payload: Any,
        timeout_s: Optional[float],
    ) -> None:
        """Stream one already-BOOKED frame, waiting (bounded by
        ``timeout_s``) for window space. Caller holds ``state.lock``.
        Raises ``WireError`` with ``request_sent=True`` on channel
        death/timeout — the caller marks ``needs_resend`` and
        ``batch_booked`` exactly like an ambiguous lock-step submit."""
        seqs = header.get("seqs")
        key = (
            tenant_id,
            tuple(seqs) if seqs is not None else (header["seq"],),
        )
        deadline = (
            None if timeout_s is None else time.monotonic() + timeout_s
        )
        with self._cv:
            while (
                self._dead is None and len(self._inflight) >= self.depth
            ):
                remaining = (
                    None
                    if deadline is None
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    # a window that never frees means the host stopped
                    # acking: poison the channel so every tenant's next
                    # fold goes through the resend path
                    self._fail_locked(
                        WireError(
                            "request_timeout",
                            f"pipeline window to {self.endpoint} did not "
                            f"free within {timeout_s}s.",
                            endpoint=self.endpoint,
                        )
                    )
                    break
                self._cv.wait(
                    timeout=0.5 if remaining is None else min(remaining, 0.5)
                )
            if self._dead is not None:
                err = WireError(
                    "transport",
                    f"pipeline channel to {self.endpoint} is down: "
                    f"{self._dead}",
                    endpoint=self.endpoint,
                )
                err.request_sent = True
                raise err
            self._inflight[key] = True
            if _obs._enabled:
                occupancy = sum(
                    1 for t, _s in self._inflight if t == tenant_id
                )
                _obs.histo(
                    "serve.client.inflight",
                    float(occupancy),
                    tenant=tenant_id,
                )
        try:
            with self._send_lock:
                if isinstance(payload, tuple):
                    send_frame_parts(self._sock, header, *payload)
                else:
                    send_frame(self._sock, header, payload)
        except OSError as e:
            with self._cv:
                self._inflight.pop(key, None)
            self._fail(e)
            err = WireError(
                "transport",
                f"pipelined {header.get('op')} to {self.endpoint} "
                f"failed: {e}",
                endpoint=self.endpoint,
            )
            err.request_sent = True
            raise err from e

    def wait_idle(
        self,
        tenant_id: str,
        state: "_ClientTenant",
        timeout_s: Optional[float],
    ) -> None:
        """Block until no frames for ``tenant_id`` are in flight, then
        fold its parked acks (caller holds ``state.lock``). Never
        raises: a timeout poisons the channel, which the fold turns
        into ``needs_resend``."""
        deadline = (
            None if timeout_s is None else time.monotonic() + timeout_s
        )
        with self._cv:
            while self._dead is None and any(
                t == tenant_id for t, _s in self._inflight
            ):
                remaining = (
                    None
                    if deadline is None
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    self._fail_locked(
                        WireError(
                            "request_timeout",
                            f"pipelined tail for tenant {tenant_id!r} was "
                            f"not acked within {timeout_s}s.",
                            endpoint=self.endpoint,
                        )
                    )
                    break
                self._cv.wait(
                    timeout=0.5 if remaining is None else min(remaining, 0.5)
                )
        self.fold_locked(tenant_id, state)

    def forget(self, tenant_id: str) -> None:
        """Drop every record of ``tenant_id`` (export/migration: the
        replay buffer travels; stale acks and window slots must not)."""
        with self._cv:
            self._pending.pop(tenant_id, None)
            self._dirty.discard(tenant_id)
            stale = [k for k in self._inflight if k[0] == tenant_id]
            for k in stale:
                del self._inflight[k]
            if stale:
                self._cv.notify_all()

    def close(self, timeout_s: float = 5.0) -> None:
        """Give in-flight frames a bounded grace to drain, then sever.
        Un-acked frames stay booked in their replay buffers — the safe
        state for a closing client (a future adopt replays them)."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._dead is None and self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=min(remaining, 0.5))
            if self._dead is None:
                self._dead = ServeError(
                    "client_closed", "EvalClient is closed."
                )
            self._cv.notify_all()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._reader is not threading.current_thread():
            self._reader.join(timeout=2.0)


class EvalClient:
    """Wire client for one eval-service host. See module doc.

    ``address`` is ``"host:port"`` or a ``(host, port)`` tuple. All
    deadline knobs are validated eagerly (NaN/inf/non-positive raise
    ``ValueError`` before any socket exists).
    """

    def __init__(
        self,
        address: Any,
        *,
        request_timeout_s: Optional[float] = 30.0,
        connect_timeout_s: Optional[float] = 5.0,
        max_attempts: int = 5,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        max_in_flight: int = 8,
        breaker_threshold: int = 3,
        breaker_reset_s: float = 1.0,
        replay_capacity: int = 64,
        submit_buffer: int = 1,
        codec: Optional[str] = None,
        pipeline_depth: int = 1,
        local_transport: bool = True,
    ) -> None:
        from torcheval_tpu_torch.metrics.toolkit import _check_timeout_s

        for knob, value in (
            ("request_timeout_s", request_timeout_s),
            ("connect_timeout_s", connect_timeout_s),
            ("backoff_base_s", backoff_base_s),
            ("backoff_cap_s", backoff_cap_s),
            ("breaker_reset_s", breaker_reset_s),
        ):
            try:
                _check_timeout_s(value)
            except ValueError as e:
                raise ValueError(f"{knob}: {e}") from None
        for knob, value, floor in (
            ("max_attempts", max_attempts, 1),
            ("max_in_flight", max_in_flight, 1),
            ("breaker_threshold", breaker_threshold, 1),
            ("replay_capacity", replay_capacity, 1),
            ("submit_buffer", submit_buffer, 1),
            ("pipeline_depth", pipeline_depth, 1),
        ):
            if not isinstance(value, int) or value < floor:
                raise ValueError(
                    f"{knob} must be an int >= {floor}, got {value!r}."
                )
        # wire-codec preference: "raw" never offers, "delta"
        # offers the lossless integer codec, "qblk" additionally offers
        # block-quantized f32 leaves (bounded error — an explicit opt-in).
        # None defers to TORCHEVAL_TPU_WIRE_CODEC (default raw). The
        # preference only OFFERS: encoding starts after the server
        # advertises support at attach, so a raw-only peer degrades the
        # wire to raw with no protocol error.
        from torcheval_tpu_torch.utils.quant import wire_codec_default

        if codec is None:
            codec = wire_codec_default()
        if codec not in ("raw", "delta", "qblk"):
            raise ValueError(
                "codec must be one of 'raw', 'delta', 'qblk' (or None "
                f"for the TORCHEVAL_TPU_WIRE_CODEC default), got {codec!r}."
            )
        self._codec_pref = codec
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            try:
                self._addr: Tuple[str, int] = (host, int(port))
            except ValueError:
                raise ValueError(
                    f"address must be 'host:port' or (host, port), "
                    f"got {address!r}."
                ) from None
        else:
            host, port = address
            self._addr = (str(host), int(port))
        self.endpoint = f"{self._addr[0]}:{self._addr[1]}"
        self._request_timeout_s = request_timeout_s
        self._connect_timeout_s = connect_timeout_s
        self._max_attempts = max_attempts
        self._backoff_base_s = backoff_base_s
        self._backoff_cap_s = backoff_cap_s
        self._breaker_threshold = breaker_threshold
        self._breaker_reset_s = breaker_reset_s
        self.replay_capacity = replay_capacity
        # submit coalescing: >1 buffers this many booked
        # batches per tenant and ships them as ONE submit_many frame —
        # frame overhead (round trip, headers, archive directory)
        # amortizes over the group exactly like the daemon's coalesced
        # H2D amortizes transfers. Batches are booked into the replay
        # buffer at submit() time, so the reliability story is unchanged:
        # anything unsent or unacked is redelivered by replay + dedup.
        self.submit_buffer = min(submit_buffer, replay_capacity)
        # deferred-ack pipelining: >1 ASKS the server at
        # attach for a streamed-submit window this deep; the grant (the
        # min of both sides: an old peer degrades, never breaks) drives a
        # dedicated channel socket opened lazily on the first submit.
        # 1 keeps today's lock-step request-response wire.
        self.pipeline_depth = min(pipeline_depth, replay_capacity)
        # same-host fast path: hand submit payloads to an
        # in-process server directly instead of round-tripping the
        # loopback socket. Auto-selected per call; False forces TCP
        # (benchmarks measuring the socket path want the real wire).
        self._local_transport = bool(local_transport)
        self._pipeline_granted = 0
        self._pipeline_unsupported = False
        self._channel: Optional[_PipelinedChannel] = None
        self._channel_lock = threading.Lock()
        self._inflight = threading.BoundedSemaphore(max_in_flight)
        self._lock = threading.Lock()
        self._pool: List[socket.socket] = []
        self._closed = False
        self._breaker_failures = 0
        self._breaker_opened_at = 0.0
        self._breaker_probing = False
        self._tenants: Dict[str, _ClientTenant] = {}
        self._subscriptions: List[ObsSubscription] = []

    # ------------------------------------------------------------ transport
    def _checkout(self) -> socket.socket:
        with self._lock:
            if self._closed:
                raise ServeError("client_closed", "EvalClient is closed.")
            if self._pool:
                return self._pool.pop()
        sock = socket.create_connection(
            self._addr, timeout=self._connect_timeout_s
        )
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        return sock

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed:
                self._pool.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def close(self) -> None:
        # best-effort: ship any coalesced unsent tails first — a buffered
        # submit() returned True for these batches, so dropping them
        # silently on close would break the delivered-on-True contract.
        # A drain failure is swallowed (we are closing; the batches stay
        # booked in the replay buffer for a future migration/adopt).
        with self._lock:
            tenants = list(self._tenants.items())
        for tenant_id, state in tenants:
            try:
                with state.lock:
                    if (
                        state.sendbuf
                        and not state.migrated
                        and not state.needs_resend
                    ):
                        self._drain_sendbuf_locked(
                            tenant_id, state, _UNSET
                        )
            except (ServeError, WireError, OSError):
                pass
        with self._lock:
            self._closed = True
            pool, self._pool = self._pool, []
            subs, self._subscriptions = self._subscriptions, []
        with self._channel_lock:
            ch, self._channel = self._channel, None
        if ch is not None:
            # bounded grace for the in-flight tail; anything un-acked
            # stays booked in its replay buffer (adopt replays it)
            ch.close()
        for sub in subs:
            sub.stop()
        for sock in pool:
            try:
                sock.close()
            except OSError:
                pass

    def __enter__(self) -> "EvalClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- breaker
    def _breaker_gate(self) -> None:
        with self._lock:
            if self._breaker_failures < self._breaker_threshold:
                return
            if (
                time.monotonic() - self._breaker_opened_at
                >= self._breaker_reset_s
            ) and not self._breaker_probing:
                # half-open: exactly ONE probe goes to the socket; every
                # other caller keeps failing fast until it reports back
                self._breaker_probing = True
                return
        if _obs._enabled:
            _obs.counter(
                "serve.client.breaker", event="fastfail", endpoint=self.endpoint
            )
        raise WireError(
            "circuit_open",
            f"circuit to {self.endpoint} is open after "
            f"{self._breaker_threshold} consecutive transport failures; "
            f"failing fast for {self._breaker_reset_s}s.",
            endpoint=self.endpoint,
        )

    def _breaker_failure(self) -> None:
        with self._lock:
            self._breaker_probing = False
            self._breaker_failures += 1
            opened = self._breaker_failures == self._breaker_threshold
            if opened or (
                self._breaker_failures > self._breaker_threshold
            ):
                self._breaker_opened_at = time.monotonic()
        if opened and _obs._enabled:
            _obs.counter(
                "serve.client.breaker", event="open", endpoint=self.endpoint
            )

    def _breaker_success(self) -> None:
        with self._lock:
            self._breaker_probing = False
            self._breaker_failures = 0

    # ---------------------------------------------------------------- calls
    def _call(
        self,
        op: str,
        header: Dict[str, Any],
        payload: bytes = b"",
        *,
        timeout_s: Any = _UNSET,
        attempts: Optional[int] = None,
        ambiguity_box: Optional[dict] = None,
    ) -> Tuple[Dict[str, Any], bytes]:
        """One wire request with the full reliability stack (deadline,
        breaker, bounded in-flight, backoff retries). Safe to blind-retry
        by construction: submits are deduplicated by seq, attach/detach
        are idempotent (nonce / already-gone-counts-as-done), and every
        other op is a read. ``attempts`` overrides ``max_attempts`` for
        this call (health probes want to fail fast). ``ambiguity_box``,
        when given, has its ``"sent"`` entry incremented for every
        attempt that may have REACHED the server without an answer — a
        caller that must know whether an earlier try could have landed
        (submit's rollback logic) reads it."""
        from torcheval_tpu_torch.metrics.toolkit import _check_timeout_s

        if timeout_s is _UNSET:
            timeout_s = self._request_timeout_s
        else:
            _check_timeout_s(timeout_s)
        max_attempts = self._max_attempts if attempts is None else attempts
        header = {"op": op, **header}
        delay_s = self._backoff_base_s
        for attempt in range(1, max_attempts + 1):
            self._breaker_gate()
            try:
                response = self._roundtrip(header, payload, timeout_s)
            except WireError as e:
                if ambiguity_box is not None and getattr(
                    e, "request_sent", False
                ):
                    # the request went out before the failure: the server
                    # may have processed it even though we got no answer
                    ambiguity_box["sent"] = ambiguity_box.get("sent", 0) + 1
                if e.reason == "protocol":
                    # the peer speaks something else; retrying cannot fix it
                    self._breaker_failure()
                    raise
                self._breaker_failure()
                if attempt == max_attempts:
                    raise
                delay_s = self._sleep_backoff(delay_s, e.reason)
                continue
            self._breaker_success()
            resp_header, resp_payload = response
            if resp_header.get("ok"):
                return resp_header, resp_payload
            err = decode_error(resp_header.get("error", {}))
            if (
                getattr(err, "retryable", False)
                and attempt < max_attempts
            ):
                delay_s = self._sleep_backoff(
                    delay_s, getattr(err, "reason", "remote")
                )
                continue
            raise err
        raise AssertionError("unreachable")  # pragma: no cover

    def _roundtrip(
        self,
        header: Dict[str, Any],
        payload: bytes,
        timeout_s: Optional[float],
    ) -> Tuple[Dict[str, Any], bytes]:
        if self._local_transport and header.get("op") in (
            "submit",
            "submit_many",
        ):
            server = local_server(self.endpoint)
            if server is not None:
                # same-host fast path: the payload (or the staging slot
                # it is assembled into) IS the buffer the daemon
                # decodes — no socket, no frame codec, no copy pair.
                # Structured rejects come back as the same ok=False
                # response frames, so the caller's retry/un-book logic
                # is transport-agnostic.
                with self._inflight:
                    try:
                        return server.local_request(dict(header), payload)
                    except OSError as e:
                        err = WireError(
                            "transport",
                            f"local transport to {self.endpoint} "
                            f"failed: {e}",
                            endpoint=self.endpoint,
                        )
                        # the dispatch may have run before a partition
                        # tripped; ambiguous, like any failed send
                        err.request_sent = True
                        raise err from e
        with self._inflight:
            try:
                sock = self._checkout()
            except OSError as e:
                err = WireError(
                    "transport",
                    f"cannot connect to {self.endpoint}: {e}",
                    endpoint=self.endpoint,
                )
                err.request_sent = False  # never left this process
                raise err from e
            try:
                sock.settimeout(timeout_s)
                if isinstance(payload, tuple):
                    # scatter-gather payload (parts, total): array data
                    # goes straight from its owning buffers to the kernel
                    send_frame_parts(sock, header, *payload)
                else:
                    send_frame(sock, header, payload)
                frame = recv_frame(sock)
            except socket.timeout:
                self._discard(sock)
                err = WireError(
                    "request_timeout",
                    f"{header.get('op')} to {self.endpoint} produced no "
                    f"response within {timeout_s}s.",
                    endpoint=self.endpoint,
                )
                err.request_sent = True
                raise err from None
            except OSError as e:
                self._discard(sock)
                err = WireError(
                    "transport",
                    f"{header.get('op')} to {self.endpoint} failed: {e}",
                    endpoint=self.endpoint,
                )
                # a failed send MAY still have delivered bytes the server
                # acted on; only a connect failure is unambiguous
                err.request_sent = True
                raise err from e
            except WireError as e:
                self._discard(sock)
                e.request_sent = True
                raise
            if frame is None:
                self._discard(sock)
                err = WireError(
                    "transport",
                    f"{self.endpoint} closed the connection before "
                    "answering.",
                    endpoint=self.endpoint,
                )
                err.request_sent = True
                raise err
            self._checkin(sock)
            return frame

    @staticmethod
    def _discard(sock: socket.socket) -> None:
        try:
            sock.close()
        except OSError:
            pass

    def _sleep_backoff(self, delay_s: float, reason: str) -> float:
        if _obs._enabled:
            _obs.counter("serve.client.retries", reason=reason)
        time.sleep(min(delay_s, self._backoff_cap_s) * (0.5 + random.random()))
        return delay_s * 2

    @staticmethod
    def _account_payload(codec: str, np_args_groups, encoded: int) -> None:
        """Raw-vs-encoded byte counters per codec: the pair makes the
        wire's compression ratio (and the raw==encoded invariant of the
        raw codec) readable straight off the client registry."""
        if not _obs._enabled:
            return
        raw = float(
            sum(
                int(a.nbytes)
                for args in np_args_groups
                for a in args
            )
        )
        _obs.counter("serve.client.payload_raw_bytes", raw, codec=codec)
        _obs.counter(
            "serve.client.payload_bytes", float(encoded), codec=codec
        )

    def _submit_header(
        self, tenant_id: str, codec: str, **fields: Any
    ) -> Dict[str, Any]:
        header = {"tenant": tenant_id, **fields}
        if codec != "raw":
            header["codec"] = codec
        return header

    # ----------------------------------------------------------- tenant api
    def attach(
        self,
        tenant_id: str,
        spec: Dict[str, Any],
        *,
        nan_policy: Optional[str] = None,
        watchdog_timeout_s: Optional[float] = None,
        step_timeout_s: Optional[float] = None,
        queue_capacity: Optional[int] = None,
        resume: Optional[str] = None,
        window_chunks: Optional[int] = None,
        approx=None,
        slices=None,
        timeout_s: Any = _UNSET,
    ) -> Dict[str, Any]:
        """Attach ``tenant_id`` with a wire metric spec (see
        :func:`metric_spec`). Returns ``{"last_seq": durable_watermark}``
        — 0 for a fresh tenant, the checkpoint's acked watermark for a
        resumed one. Admission failures raise the same structured
        :class:`AdmissionError` a local ``attach`` would. The request
        carries a one-shot nonce so a blind retry after an ambiguous
        failure (our attach landed, the ack did not) is recognized
        server-side and answered with the ORIGINAL success instead of
        ``duplicate_tenant`` — attach is idempotent per call, like
        submit. ``slices`` threads the per-cohort config
        (``True`` / capacity int / ``{"capacity":, "curve_bucket_bits":}``;
        it also takes ``"mesh_axis": str`` — a plain axis-name string the
        DAEMON turns into a slice-axis-sharded collection over its own
        local devices, so no device handle ever crosses the wire) — every
        ``submit`` for a sliced tenant must then carry the ``slice_ids``
        integer column as its FIRST argument, and ``compute`` returns
        per-slice ``{"slice_ids": ..., "values": ...}`` results per
        member."""
        req = {
            "tenant": tenant_id,
            "spec": spec,
            "nonce": uuid.uuid4().hex,
            "nan_policy": nan_policy,
            "watchdog_timeout_s": watchdog_timeout_s,
            "step_timeout_s": step_timeout_s,
            "queue_capacity": queue_capacity,
            "resume": resume,
            "window_chunks": window_chunks,
            "approx": approx,
            "slices": slices,
        }
        if self._codec_pref != "raw":
            # capability exchange: qblk implies the lossless delta codec
            # as a second choice, so a delta-only server still compresses
            req["codecs"] = (
                ["qblk", "delta"]
                if self._codec_pref == "qblk"
                else ["delta"]
            )
        if self.pipeline_depth >= 2:
            # same handshake discipline as the codec offer: the server
            # grants min(ask, its own cap) in the response, an old
            # server ignores the field entirely — either way the wire
            # degrades to lock-step with no protocol error
            req["pipeline"] = self.pipeline_depth
        header, _ = self._call("attach", req, timeout_s=timeout_s)
        last_seq = int(header.get("last_seq", 0))
        codec = str(header.get("codec") or "raw")
        granted = header.get("pipeline")
        if (
            isinstance(granted, int)
            and not isinstance(granted, bool)
            and granted >= 2
        ):
            with self._channel_lock:
                self._pipeline_granted = max(
                    self._pipeline_granted, granted
                )
        with self._lock:
            self._tenants[tenant_id] = _ClientTenant(last_seq, codec)
        return {"last_seq": last_seq, "codec": codec}

    def _tenant_state(self, tenant_id: str) -> _ClientTenant:
        with self._lock:
            state = self._tenants.get(tenant_id)
        if state is None:
            raise ServeError(
                "unknown_tenant",
                f"tenant {tenant_id!r} is not attached through this client.",
            )
        return state

    # ------------------------------------------------------ pipeline channel
    def _pipeline_channel(
        self, timeout_s: Any
    ) -> Optional[_PipelinedChannel]:
        """The live deferred-ack channel, opening one lazily. ``None``
        means this call runs lock-step: pipelining was never granted at
        attach, the peer rejected ``pipeline_open`` (an old or
        pipeline-disabled server — remembered, never re-probed), the
        endpoint is served in-process (the local transport already
        skips the round trip a window would overlap), or the open
        itself hit transport trouble (the lock-step path owns the
        breaker/retry story)."""
        if self._pipeline_granted < 2 or self._pipeline_unsupported:
            return None
        if (
            self._local_transport
            and local_server(self.endpoint) is not None
        ):
            return None
        with self._channel_lock:
            old = self._channel
            if old is not None and old.alive:
                return old
            # a dead channel STAYS registered until a live replacement
            # exists: its parked acks and dirty flags must keep feeding
            # sync-point folds if this open attempt fails
            try:
                sock = socket.create_connection(
                    self._addr, timeout=self._connect_timeout_s
                )
            except OSError:
                return None
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            try:
                sock.settimeout(self._effective_timeout(timeout_s))
                send_frame(
                    sock,
                    {
                        "op": "pipeline_open",
                        "depth": self._pipeline_granted,
                    },
                )
                frame = recv_frame(sock)
            except (OSError, WireError):
                self._discard(sock)
                return None
            if frame is None:
                self._discard(sock)
                return None
            header, _payload = frame
            if not header.get("ok"):
                self._discard(sock)
                err = decode_error(header.get("error", {}))
                if (
                    isinstance(err, WireError)
                    and getattr(err, "reason", None) == "protocol"
                ):
                    # an old peer degrades the wire to
                    # lock-step for the client's lifetime, never breaks
                    self._pipeline_unsupported = True
                return None
            try:
                depth = int(header.get("depth", 0))
            except (TypeError, ValueError):
                depth = 0
            if depth < 2:
                self._discard(sock)
                self._pipeline_unsupported = True
                return None
            sock.settimeout(None)  # acks arrive on the server's schedule
            ch = _PipelinedChannel(sock, depth, self.endpoint)
            if old is not None:
                # carry the dead channel's unfolded bookkeeping over:
                # parked acks and needs-resend flags must survive the
                # swap, or a tenant that never submits again (compute
                # only) would miss its error acks at the sync point
                with old._cv:
                    pend, old._pending = old._pending, {}
                    dirty, old._dirty = set(old._dirty), set()
                with ch._cv:
                    for t, acks in pend.items():
                        ch._pending.setdefault(t, []).extend(acks)
                    ch._dirty |= dirty
            self._channel = ch
            return ch

    def _channel_quiesce_locked(
        self, tenant_id: str, state: _ClientTenant, timeout_s: Any
    ) -> None:
        """Drain + fold this tenant's pipelined in-flight tail (no-op
        without a channel; caller holds ``state.lock``). Leaves
        ``needs_resend`` set when an ack reported an error or the
        channel died — the caller's resend path settles delivery."""
        with self._channel_lock:
            ch = self._channel
        if ch is not None:
            ch.wait_idle(
                tenant_id, state, self._effective_timeout(timeout_s)
            )

    def submit(
        self, tenant_id: str, *args: Any, timeout_s: Any = _UNSET
    ) -> bool:
        """Submit one update batch. Assigns the next sequence number,
        holds the batch in the bounded replay buffer until it is durable,
        and retries transparently (dedup makes resends exactly-once).
        Returns ``True`` if this call's send was applied, ``False`` if
        the server had it already (a prior ambiguous attempt landed).
        Under ``submit_buffer > 1`` or an active pipeline channel the
        return is always ``True`` (the batch is BOOKED; the server's
        per-batch dedup verdicts ride the coalesced or deferred ack and
        are not reported per call) — callers that need the per-batch
        applied signal use an unbuffered lock-step client."""
        state = self._tenant_state(tenant_id)
        np_args = tuple(_host_array(a) for a in args)
        with state.lock:
            if state.migrated:
                raise ServeError(
                    "tenant_migrated",
                    f"tenant {tenant_id!r} was migrated off this host "
                    "mid-call; re-route and resubmit (the batch was not "
                    "booked).",
                )
            ch = self._pipeline_channel(timeout_s)
            try:
                if ch is not None:
                    # fold parked acks first: an error ack must flip
                    # needs_resend BEFORE this call sequences past it
                    ch.fold_locked(tenant_id, state)
                if state.needs_resend:
                    self._channel_quiesce_locked(
                        tenant_id, state, timeout_s
                    )
                    self._resend_locked(tenant_id, state, timeout_s)
                if len(state.replay) >= self.replay_capacity:
                    # replay valve: drain the pipelined tail first (its
                    # acks alone may free the buffer), then checkpoint
                    # server-side to advance the durable watermark and
                    # prune — the buffer stays bounded without ever
                    # dropping a non-durable batch
                    self._channel_quiesce_locked(
                        tenant_id, state, timeout_s
                    )
                    if state.needs_resend:
                        self._resend_locked(tenant_id, state, timeout_s)
                    if len(state.replay) >= self.replay_capacity:
                        self._flush_locked(tenant_id, state, timeout_s)
            except (WireError, ServeError) as e:
                # pre-booking failure: earlier BOOKED entries redeliver
                # through replay, but THIS call's batch was never booked —
                # a batch_booked=True leaking out of the flush's internal
                # drain would make the router skip resubmitting it
                e.batch_booked = False
                raise
            if self.submit_buffer > 1:
                return self._buffered_submit_locked(
                    tenant_id, state, np_args, timeout_s
                )
            # marshal BEFORE booking: an unmarshalable or over-limit
            # argument must fail this call cleanly, not leave a poison
            # entry in the replay buffer that every future resend and
            # migration chokes on (the server would drop an oversize
            # frame without answering, which reads as host death)
            spec, blob = pack_tree(list(np_args), codec=state.codec)
            self._account_payload(state.codec, [np_args], len(blob))
            from torcheval_tpu_torch.serve.wire import _MAX_PAYLOAD_BYTES

            if len(blob) > _MAX_PAYLOAD_BYTES:
                raise WireError(
                    "protocol",
                    f"batch payload is {len(blob)} bytes, over the "
                    f"{_MAX_PAYLOAD_BYTES}-byte wire limit; split the "
                    "batch.",
                    endpoint=self.endpoint,
                )
            seq = state.next_seq
            state.next_seq += 1
            state.replay.append((seq, np_args))
            if ch is not None:
                wire_header = self._submit_header(
                    tenant_id, state.codec, seq=seq, args=spec
                )
                wire_header["op"] = "submit"
                # the bound the server's gapless admission blocks under
                wire_header["timeout"] = self._effective_timeout(
                    timeout_s
                )
                try:
                    ch.send(
                        tenant_id,
                        state,
                        wire_header,
                        blob,
                        self._effective_timeout(timeout_s),
                    )
                except WireError as e:
                    # ambiguous, exactly like the lock-step transport
                    # branch: the frame may be on the wire — booked +
                    # needs_resend settle it at the next call
                    state.needs_resend = True
                    e.batch_booked = True
                    raise
                # streamed: the ack rides back asynchronously and folds
                # at the next submit/flush/compute; True means BOOKED
                return True
            ambiguity: dict = {}
            try:
                header, _ = self._call(
                    "submit",
                    self._submit_header(
                        tenant_id, state.codec, seq=seq, args=spec
                    ),
                    blob,
                    timeout_s=timeout_s,
                    ambiguity_box=ambiguity,
                )
            except WireError as e:
                # ambiguous: the batch may or may not have landed. It
                # STAYS booked in the replay buffer under its seq — a
                # migration replays it, dedup absorbs the overlap. Mark
                # the error so the router knows delivery is now the
                # replay buffer's job and must NOT resubmit the batch
                # under a fresh seq (that would double-apply it). A
                # direct (router-less) caller that keeps submitting is
                # covered by needs_resend: the next call re-delivers this
                # booked tail before any new seq can advance the daemon
                # watermark past the hole.
                state.needs_resend = True
                e.batch_booked = True
                raise
            except ServeError as e:
                if not ambiguity.get("sent"):
                    # a STRUCTURED reject with NO earlier ambiguous send:
                    # the daemon saw this seq exactly once and did not
                    # admit it (shed after retries, quarantine,
                    # draining) — un-book it so the replay buffer never
                    # re-applies a rejected batch
                    state.replay.pop()
                    state.next_seq = seq
                else:
                    # an earlier attempt of this seq MAY have been
                    # admitted before its ack was lost; rolling the seq
                    # back would hand it to the NEXT batch, which the
                    # daemon would then dedup away (silent loss). Keep
                    # the booking: replay/dedup settle it exactly-once —
                    # and flag the resend catch-up exactly like the
                    # transport branch, or a later seq could advance the
                    # daemon watermark past this possibly-unapplied hole.
                    state.needs_resend = True
                    e.batch_booked = True
                raise
            state.durable_seq = max(
                state.durable_seq, int(header.get("acked_seq", 0))
            )
            self._prune_locked(state)
            return bool(header.get("applied", True))

    def _buffered_submit_locked(
        self,
        tenant_id: str,
        state: _ClientTenant,
        np_args: tuple,
        timeout_s: Any,
    ) -> bool:
        """Book one batch into the replay buffer AND the coalesced send
        tail; ship the tail as one ``submit_many`` frame when it reaches
        ``submit_buffer`` batches (or would overflow the frame limit).
        Returns ``True`` — the batch is booked; any dedup of an earlier
        ambiguous landing happens server-side when the frame ships."""
        from torcheval_tpu_torch.serve.wire import _MAX_PAYLOAD_BYTES

        for a in np_args:
            if a.dtype.hasobject:
                # validate at booking time: a poison entry must fail THIS
                # call, never lurk in the replay buffer
                raise WireError(
                    "protocol",
                    "cannot marshal object arrays over the eval wire.",
                    endpoint=self.endpoint,
                )
        nbytes = sum(int(a.nbytes) for a in np_args) + 4096
        if nbytes > _MAX_PAYLOAD_BYTES:
            raise WireError(
                "protocol",
                f"batch payload is ~{nbytes} bytes, over the "
                f"{_MAX_PAYLOAD_BYTES}-byte wire limit; split the batch.",
                endpoint=self.endpoint,
            )
        pending = sum(
            sum(int(a.nbytes) for a in args) + 4096
            for _seq, args in state.sendbuf
        )
        if state.sendbuf and pending + nbytes > _MAX_PAYLOAD_BYTES:
            try:
                self._drain_sendbuf_locked(tenant_id, state, timeout_s)
            except (WireError, ServeError) as e:
                # the drained tail is booked (replay covers it); THIS
                # batch is not — the caller must resubmit it
                e.batch_booked = False
                raise
        seq = state.next_seq
        state.next_seq += 1
        state.replay.append((seq, np_args))
        state.sendbuf.append((seq, np_args))
        if len(state.sendbuf) >= self.submit_buffer:
            self._drain_sendbuf_locked(tenant_id, state, timeout_s)
        return True

    def _drain_sendbuf_locked(
        self, tenant_id: str, state: _ClientTenant, timeout_s: Any
    ) -> None:
        """Ship the booked-but-unsent tail as ONE ``submit_many`` frame.
        On any failure the whole group stays booked in the replay buffer
        (``needs_resend``): redelivery in seq order + server dedup settle
        whichever prefix actually landed, exactly once."""
        if not state.sendbuf:
            return
        take, state.sendbuf = state.sendbuf, []
        seqs = [seq for seq, _args in take]
        spec, parts, total = pack_tree_parts(
            [list(args) for _seq, args in take], codec=state.codec
        )
        self._account_payload(
            state.codec, [args for _seq, args in take], total
        )
        ch = self._pipeline_channel(timeout_s)
        if ch is not None:
            wire_header = self._submit_header(
                tenant_id, state.codec, seqs=seqs, args=spec
            )
            wire_header["op"] = "submit_many"
            wire_header["timeout"] = self._effective_timeout(timeout_s)
            try:
                ch.send(
                    tenant_id,
                    state,
                    wire_header,
                    (parts, total),
                    self._effective_timeout(timeout_s),
                )
            except WireError as e:
                state.needs_resend = True
                e.batch_booked = True
                raise
            return  # the deferred ack folds at the next sync point
        try:
            header, _ = self._call(
                "submit_many",
                self._submit_header(
                    tenant_id, state.codec, seqs=seqs, args=spec
                ),
                (parts, total),
                timeout_s=timeout_s,
            )
        except (WireError, ServeError) as e:
            state.needs_resend = True
            e.batch_booked = True
            raise
        state.durable_seq = max(
            state.durable_seq, int(header.get("acked_seq", 0))
        )
        self._prune_locked(state)

    def _drain_for(self, tenant_id: str, timeout_s: Any) -> None:
        """Deliver any coalesced booked-but-undelivered tail before an op
        whose result must reflect every prior ``submit``
        (compute/sync_compute/detach). The needs-resend check comes
        FIRST: a failed coalesced drain empties the send tail but leaves
        its batches booked in the replay buffer, and those must redeliver
        too — a ``submit()`` that returned ``True`` may never silently
        miss a compute. Buffered (``submit_buffer > 1``) and pipelined
        (a channel was opened) clients only: both return ``True`` for
        batches still on their way, so the sync point must land them.
        The unbuffered lock-step client's long-standing semantics — a
        FAILED submit's hole redelivers at the next submit/flush, not
        at compute — stay exactly as they were."""
        with self._channel_lock:
            pipelined = self._channel is not None
        if self.submit_buffer <= 1 and not pipelined:
            return
        with self._lock:
            state = self._tenants.get(tenant_id)
        if state is None:
            return
        with state.lock:
            if state.migrated:
                return
            self._channel_quiesce_locked(tenant_id, state, timeout_s)
            if state.needs_resend:
                self._resend_locked(tenant_id, state, timeout_s)
            if state.sendbuf:
                self._drain_sendbuf_locked(tenant_id, state, timeout_s)
                # a pipelined drain only STREAMS the tail; land it
                self._channel_quiesce_locked(tenant_id, state, timeout_s)
                if state.needs_resend:
                    self._resend_locked(tenant_id, state, timeout_s)

    def flush(self, tenant_id: str, *, timeout_s: Any = _UNSET) -> dict:
        """Checkpoint the tenant server-side (no eviction), advance the
        durable watermark, prune the replay buffer. Returns
        ``{"path": ..., "acked_seq": ...}``."""
        state = self._tenant_state(tenant_id)
        with state.lock:
            if state.migrated:
                raise ServeError(
                    "tenant_migrated",
                    f"tenant {tenant_id!r} was migrated off this host "
                    "mid-call; re-route.",
                )
            self._channel_quiesce_locked(tenant_id, state, timeout_s)
            if state.needs_resend:
                self._resend_locked(tenant_id, state, timeout_s)
            return self._flush_locked(tenant_id, state, timeout_s)

    def _send_replay_entries(
        self, tenant_id: str, state: _ClientTenant, timeout_s: Any
    ) -> int:
        """Deliver every current replay entry in seq order under the
        caller-held ``state.lock`` (the daemon dedups any that already
        landed), folding acked durable watermarks in and pruning. The
        ONE loop behind resend catch-up and migration replay — fixes to
        its semantics cannot diverge between the two. Returns the number
        of entries sent."""
        sent = 0
        for seq, np_args in list(state.replay):
            spec, blob = pack_tree(list(np_args), codec=state.codec)
            self._account_payload(state.codec, [np_args], len(blob))
            header, _ = self._call(
                "submit",
                self._submit_header(
                    tenant_id, state.codec, seq=seq, args=spec
                ),
                blob,
                timeout_s=timeout_s,
            )
            sent += 1
            state.durable_seq = max(
                state.durable_seq, int(header.get("acked_seq", 0))
            )
        self._prune_locked(state)
        return sent

    def _resend_locked(
        self, tenant_id: str, state: _ClientTenant, timeout_s: Any
    ) -> None:
        """Re-deliver the booked tail a failed submit left behind,
        clearing the hole. Raises (flag intact) if the host is still
        unreachable — nothing new may be sequenced past the hole until
        it closes. Coalesced unsent entries are already booked in the
        replay buffer, so dropping the send tail and replaying covers
        them in seq order."""
        state.sendbuf.clear()
        self._send_replay_entries(tenant_id, state, timeout_s)
        state.needs_resend = False

    def _flush_locked(
        self, tenant_id: str, state: _ClientTenant, timeout_s: Any
    ) -> dict:
        # the durable watermark a flush advances must cover the booked
        # tail: ship any coalesced unsent entries, then land the
        # pipelined in-flight window (gapless admission keeps pruning
        # safe regardless — the server watermark can never pass a hole
        # — but the replay-valve caller needs the watermark to MOVE)
        self._drain_sendbuf_locked(tenant_id, state, timeout_s)
        self._channel_quiesce_locked(tenant_id, state, timeout_s)
        if state.needs_resend:
            self._resend_locked(tenant_id, state, timeout_s)
        header, _ = self._call(
            "flush",
            {
                "tenant": tenant_id,
                "timeout": self._effective_timeout(timeout_s),
            },
            timeout_s=timeout_s,
        )
        state.durable_seq = max(
            state.durable_seq, int(header.get("acked_seq", 0))
        )
        self._prune_locked(state)
        return {"path": header.get("path"), "acked_seq": state.durable_seq}

    @staticmethod
    def _prune_locked(state: _ClientTenant) -> None:
        while state.replay and state.replay[0][0] <= state.durable_seq:
            state.replay.popleft()

    def _effective_timeout(self, timeout_s: Any) -> Optional[float]:
        """The deadline a request actually runs under — forwarded to the
        daemon side so its promise wait is bounded by the same budget the
        socket is (otherwise each client retry would park one more
        handler thread on an unbounded wait)."""
        return (
            self._request_timeout_s if timeout_s is _UNSET else timeout_s
        )

    def compute(self, tenant_id: str, *, timeout_s: Any = _UNSET) -> Any:
        self._drain_for(tenant_id, timeout_s)
        header, payload = self._call(
            "compute",
            {
                "tenant": tenant_id,
                "timeout": self._effective_timeout(timeout_s),
            },
            timeout_s=timeout_s,
        )
        return unpack_tree(header["result"], payload)

    def sync_compute(
        self,
        tenant_id: str,
        *,
        sync_timeout_s: Optional[float] = None,
        on_failure: str = "raise",
        timeout_s: Any = _UNSET,
    ) -> Any:
        """``TenantHandle.sync_compute`` over the wire: ``sync_timeout_s``
        bounds the daemon-side collective rounds (the toolkit deadline contract);
        ``timeout_s`` bounds this wire request."""
        self._drain_for(tenant_id, timeout_s)
        header, payload = self._call(
            "sync_compute",
            {
                "tenant": tenant_id,
                "timeout_s": sync_timeout_s,
                "on_failure": on_failure,
                "timeout": self._effective_timeout(timeout_s),
            },
            timeout_s=timeout_s,
        )
        return unpack_tree(header["result"], payload)

    def detach(
        self,
        tenant_id: str,
        *,
        checkpoint: bool = False,
        timeout_s: Any = _UNSET,
    ) -> Optional[str]:
        """Detach over the wire. Idempotent: a retry of a detach whose
        ack was lost finds the tenant already gone (``unknown_tenant``)
        and counts that as success — the caller asked for the tenant to
        be detached, and it is (a checkpoint path from the first landing
        is lost with the ack in that corner; ``resilience.
        latest_checkpoint(<root>/<tenant>)`` recovers it)."""
        self._drain_for(tenant_id, timeout_s)
        try:
            header, _ = self._call(
                "detach",
                {
                    "tenant": tenant_id,
                    "checkpoint": checkpoint,
                    "timeout": self._effective_timeout(timeout_s),
                },
                timeout_s=timeout_s,
            )
        except ServeError as e:
            if isinstance(e, WireError) or e.reason != "unknown_tenant":
                raise
            header = {}
        with self._lock:
            self._tenants.pop(tenant_id, None)
        return header.get("checkpoint")

    # ---------------------------------------------------------- cluster api
    def health(
        self, *, timeout_s: Any = _UNSET, attempts: Optional[int] = None
    ) -> Dict[str, Any]:
        """The host's ``daemon.health()`` snapshot. ``attempts`` caps the
        retry budget for this probe (a failure DETECTOR wants to fail
        fast, not ride the full backoff ladder)."""
        header, _ = self._call(
            "health", {}, timeout_s=timeout_s, attempts=attempts
        )
        return header["health"]

    def snapshot(self, *, timeout_s: Any = _UNSET) -> Dict[str, Any]:
        """The host's obs registry snapshot + Chrome trace (flight-record
        collection for drills and dashboards)."""
        header, payload = self._call("snapshot", {}, timeout_s=timeout_s)
        return unpack_tree(header["result"], payload)

    def load_report(self, *, timeout_s: Any = _UNSET) -> Dict[str, Any]:
        """The host's structured ``daemon.load_report()`` (schema 1) over
        a dedicated cheap wire op — the router rebalancer's pull path
        when no obs push stream is subscribed. An old server
        that predates the op rejects it as ``WireError("protocol")``;
        degrade to the ``health()`` embed (same payload, heavier probe)
        instead of failing — mixed versions degrade, never break."""
        try:
            header, _ = self._call("load_report", {}, timeout_s=timeout_s)
        except WireError as e:
            if e.reason != "protocol":
                raise
            return self.health(timeout_s=timeout_s)["load_report"]
        return header["load_report"]

    def list_tenants(
        self,
        *,
        timeout_s: Any = _UNSET,
        attempts: Optional[int] = None,
    ) -> Dict[str, Any]:
        """The host's attached-tenant directory — per tenant: ``status``,
        ``last_seq``, ``durable_seq``, plus the attach-time ``spec`` and
        ``knobs`` the server recorded. This is the recovering
        router's reconciliation pull: journal replay names the tenants it
        EXPECTS, this op names the tenants each host actually HOLDS, and
        the diff drives adopt / re-place / orphan adoption. An old server
        rejects the op as ``WireError("protocol")``; degrade to the
        ``health()`` per-tenant fold — same status + watermarks, no
        spec/knobs (orphans on old hosts stay unadoptable, a degradation
        not a break)."""
        try:
            header, _ = self._call(
                "list_tenants", {}, timeout_s=timeout_s, attempts=attempts
            )
        except WireError as e:
            if e.reason != "protocol":
                raise
            tenants = self.health(
                timeout_s=timeout_s, attempts=attempts
            ).get("tenants", {})
            return {
                tid: {
                    "status": info.get("status"),
                    "last_seq": info.get("last_seq", 0),
                    "durable_seq": info.get("durable_seq", 0),
                }
                for tid, info in tenants.items()
            }
        return header["tenants"]

    # ------------------------------------------------------------ obs stream
    def subscribe_obs(
        self,
        interval_s: float = 1.0,
        *,
        on_push: Optional[Any] = None,
        fallback: str = "poll",
    ) -> ObsSubscription:
        """Subscribe to the host's obs push channel.

        Opens a DEDICATED socket (outside the request pool — pushes are
        server-paced and must not occupy a pooled request slot), sends
        ``subscribe_obs``, and spawns a reader thread delivering each
        ``obs_push`` frame (registry delta + timeline events +
        ``load_report``) to ``on_push`` and :attr:`ObsSubscription.last`.

        An old server rejects the op with ``WireError("protocol")`` —
        never retried, never a failover trigger — and with
        ``fallback="poll"`` (default) the subscription degrades to
        polling ``health()`` on the same cadence (``mode == "poll"``).
        ``fallback="raise"`` surfaces the protocol error instead. The
        subscription is registered with this client and stopped by
        ``close()``."""
        from torcheval_tpu_torch.metrics.toolkit import _check_timeout_s

        _check_timeout_s(interval_s)
        if fallback not in ("poll", "raise"):
            raise ValueError(
                f"fallback must be 'poll' or 'raise', got {fallback!r}."
            )
        with self._lock:
            if self._closed:
                raise ServeError("client_closed", "EvalClient is closed.")
        sub = ObsSubscription(self.endpoint, float(interval_s), on_push)
        try:
            sock = socket.create_connection(
                self._addr, timeout=self._connect_timeout_s
            )
        except OSError as e:
            raise WireError(
                "transport",
                f"cannot connect to {self.endpoint} for obs stream: {e}",
                endpoint=self.endpoint,
            ) from e
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        accepted = False
        try:
            sock.settimeout(self._request_timeout_s)
            send_frame(sock, {"op": "subscribe_obs", "interval_s": interval_s})
            frame = recv_frame(sock)
            if frame is None:
                raise WireError(
                    "transport",
                    f"{self.endpoint} closed the connection before "
                    "answering subscribe_obs.",
                    endpoint=self.endpoint,
                )
            header, _payload = frame
            if header.get("ok"):
                accepted = True
            else:
                err = decode_error(header.get("error", {}))
                if (
                    isinstance(err, WireError)
                    and getattr(err, "reason", None) == "protocol"
                    and fallback == "poll"
                ):
                    # an old peer degrades, never breaks
                    accepted = False
                else:
                    raise err
        except socket.timeout:
            self._discard(sock)
            raise WireError(
                "request_timeout",
                f"subscribe_obs to {self.endpoint} produced no response "
                f"within {self._request_timeout_s}s.",
                endpoint=self.endpoint,
            ) from None
        except OSError as e:
            self._discard(sock)
            raise WireError(
                "transport",
                f"subscribe_obs to {self.endpoint} failed: {e}",
                endpoint=self.endpoint,
            ) from e
        except BaseException:
            self._discard(sock)
            raise
        if accepted:
            sub.mode = "push"
            sub._sock = sock
            sock.settimeout(None)  # pushes arrive on the server's timer
            sub._thread = threading.Thread(
                target=self._obs_read_loop,
                args=(sub, sock),
                name="torcheval-tpu-obs-subscriber",
                daemon=True,
            )
        else:
            sub.mode = "poll"
            self._discard(sock)  # the poller uses the request pool
            sub._thread = threading.Thread(
                target=self._obs_poll_loop,
                args=(sub,),
                name="torcheval-tpu-obs-poller",
                daemon=True,
            )
        with self._lock:
            self._subscriptions.append(sub)
        sub._thread.start()
        return sub

    @staticmethod
    def _obs_read_loop(sub: ObsSubscription, sock: socket.socket) -> None:
        while not sub._stop.is_set():
            try:
                frame = recv_frame(sock)
            except (OSError, WireError):
                break  # host died or stop() severed the socket
            if frame is None:
                break  # server closed: final flush already delivered
            header, _payload = frame
            if header.get("op") == "obs_push":
                sub._record(header)
        try:
            sock.close()
        except OSError:
            pass

    def _obs_poll_loop(self, sub: ObsSubscription) -> None:
        while not sub._stop.wait(sub.interval_s):
            try:
                health = self.health(attempts=1)
            except (ServeError, WireError, OSError):
                if self._closed:
                    break
                continue  # keep polling; the router judges staleness
            sub._record(
                {
                    "op": "obs_poll",
                    "endpoint": self.endpoint,
                    "load_report": health.get("load_report"),
                    "health": health,
                }
            )

    def drain(self, *, timeout_s: Any = _UNSET) -> Dict[str, Optional[str]]:
        """Ask the host to drain (evict-and-checkpoint every tenant).
        Returns ``{tenant_id: checkpoint_path}``."""
        header, _ = self._call(
            "drain",
            {"timeout": self._effective_timeout(timeout_s)},
            timeout_s=timeout_s,
        )
        return dict(header.get("tenants", {}))

    # ------------------------------------------------- migration bookkeeping
    def export_tenant(self, tenant_id: str) -> Dict[str, Any]:
        """Detach this client's local wire state for ``tenant_id`` (seqs +
        replay buffer) so the router can carry it to another host. Purely
        local: works when the host is dead."""
        with self._lock:
            state = self._tenants.pop(tenant_id, None)
        if state is None:
            raise ServeError(
                "unknown_tenant",
                f"tenant {tenant_id!r} is not attached through this client.",
            )
        with self._channel_lock:
            ch = self._channel
        with state.lock:
            state.migrated = True
            if ch is not None:
                # parked acks tighten the exported watermark (less to
                # replay); then drop the channel's window slots so a
                # deep un-acked tail cannot hold the window hostage —
                # the tail is booked in the replay buffer and the NEW
                # host's adopt replays it (old-host acks are moot)
                ch.fold_locked(tenant_id, state)
                ch.forget(tenant_id)
            # coalesced unsent entries are booked in the replay buffer,
            # so the export carries them; the new host's replay delivers
            state.sendbuf.clear()
            return {
                "next_seq": state.next_seq,
                "durable_seq": state.durable_seq,
                "replay": list(state.replay),
            }

    def drop_tenant(
        self,
        tenant_id: str,
        *,
        checkpoint: bool = False,
        timeout_s: Any = _UNSET,
    ) -> Optional[str]:
        """Server-side detach WITHOUT local wire state (a
        rebalance move exports the wire state first — ``detach`` would
        raise client-side ``unknown_tenant`` before ever reaching the
        host, yet the source daemon's attach record must still be
        released or the moved tenant keeps a capacity slot and its
        queue-load signal forever). ``checkpoint=False`` by default: the
        move's own ``flush`` already published the resume source, and a
        second publish from the source would only add a stale manifest
        to the shared root. Idempotent like :meth:`detach`."""
        try:
            header, _ = self._call(
                "detach",
                {
                    "tenant": tenant_id,
                    "checkpoint": bool(checkpoint),
                    "timeout": self._effective_timeout(timeout_s),
                },
                timeout_s=timeout_s,
            )
        except ServeError as e:
            if isinstance(e, WireError) or e.reason != "unknown_tenant":
                raise
            header = {}
        return header.get("checkpoint")

    def adopt_tenant(
        self,
        tenant_id: str,
        exported: Dict[str, Any],
        *,
        restored_seq: int,
        timeout_s: Any = _UNSET,
    ) -> int:
        """Install an exported tenant state after an ``attach`` on this
        host restored its checkpoint at ``restored_seq``, then replay the
        un-durable tail of the replay buffer (everything above the
        restored watermark) in order. Batches at or below the watermark
        came back through the checkpoint; the server dedups any overlap.
        Returns the number of batches replayed. Raises a structured
        ``checkpoint_behind`` error when the restored watermark is BELOW
        the exported durable one: entries the old host acked durable were
        already pruned from the replay buffer, so a restore that does not
        carry them (a non-shared checkpoint root, a lost directory) can
        only produce silently wrong results — refuse instead."""
        exported_durable = int(exported["durable_seq"])
        if restored_seq < exported_durable:
            raise ServeError(
                "checkpoint_behind",
                f"tenant {tenant_id!r}: restored checkpoint watermark "
                f"{restored_seq} < acked durable watermark "
                f"{exported_durable}; batches in between exist in neither "
                "the checkpoint nor the replay buffer (are the hosts "
                "sharing one checkpoint root?).",
            )
        with self._lock:
            attached = self._tenants.get(tenant_id)
        # the router attaches on this host BEFORE adopting, so the codec
        # that attach negotiated carries into the replayed submits
        state = _ClientTenant(0, attached.codec if attached else "raw")
        state.next_seq = int(exported["next_seq"])
        state.durable_seq = max(exported_durable, restored_seq)
        state.replay = deque(
            (int(seq), tuple(args))
            for seq, args in exported["replay"]
            if int(seq) > state.durable_seq
        )
        with self._lock:
            self._tenants[tenant_id] = state
        with state.lock:
            replayed = self._send_replay_entries(
                tenant_id, state, timeout_s
            )
        if replayed and _obs._enabled:
            _obs.counter(
                "serve.router.replays", float(replayed), tenant=tenant_id
            )
        return replayed

    def adopt_attached(self, tenant_id: str, last_seq: int) -> None:
        """Install client-side wire state for a tenant that is ALREADY
        attached server-side (a recovered router re-adopting a
        live tenant — ``attach`` would raise ``duplicate_tenant``, and a
        detach/re-attach round-trip would discard queued batches). Seeds
        the seq cursor from the host's reported ``last_seq`` so the next
        submit continues the exactly-once stream; the codec stays "raw"
        (frames are self-describing — a codec is a per-attach bandwidth
        negotiation, not a correctness requirement). The replay buffer
        starts empty: everything at or below ``last_seq`` is applied on
        the host, and nothing above it was ever submitted through this
        client. Idempotent; refuses to clobber live local state."""
        with self._lock:
            if tenant_id not in self._tenants:
                self._tenants[tenant_id] = _ClientTenant(int(last_seq))
