"""Tenant state machine + the client-side handle.

JAX counterpart: ``torcheval_tpu/serve/tenant.py``, ported whole.

A *tenant* is one eval stream served by the daemon: a
:class:`~torcheval_tpu_torch.metrics.MetricCollection` it owns, a bounded
ingestion queue, and a lifecycle status. All device work happens on the
daemon's worker thread; the :class:`TenantHandle` a client holds only
enqueues work and waits on promises, so any number of producer threads can
feed one daemon — the many-producers / one-device-consumer topology
(Podracer, arXiv:2104.06272).

Lifecycle::

    ACTIVE --(poisoned batch / NaN policy / compute raise / step
              deadline)--> QUARANTINED     (structured error; slot held
                                            until detach; state suspect,
                                            never checkpointed)
    ACTIVE --(watchdog idle deadline / evict() / detach(checkpoint=True))
           --> EVICTED                     (state folded + checkpointed
                                            via resilience.save; slot
                                            freed; reattach resumes
                                            bit-identically)
    ACTIVE --(detach())--> DETACHED        (slot freed, state dropped)
"""

from __future__ import annotations

import enum
import threading
import time
from collections import deque
from typing import Any, Optional

from torcheval_tpu_torch.serve.errors import ServeError

__all__ = ["TenantStatus", "TenantHandle"]


class TenantStatus(enum.Enum):
    ACTIVE = "active"
    QUARANTINED = "quarantined"
    EVICTED = "evicted"
    DETACHED = "detached"


class _Promise:
    """One worker-fulfilled result slot (compute/detach round trips)."""

    __slots__ = ("event", "value", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.value: Any = None
        self.error: Optional[BaseException] = None

    def resolve(self, value: Any) -> None:
        self.value = value
        self.event.set()

    def reject(self, error: BaseException) -> None:
        self.error = error
        self.event.set()

    def result(self, timeout: Optional[float]) -> Any:
        if not self.event.wait(timeout):
            raise ServeError(
                "result_timeout",
                f"daemon did not produce a result within {timeout}s "
                "(worker busy or stalled; see daemon.health()).",
            )
        if self.error is not None:
            raise self.error
        return self.value


class _Tenant:
    """Daemon-internal per-tenant record. Mutated only under the daemon
    lock (status, queue, stats) or on the worker thread (collection)."""

    __slots__ = (
        "id",
        "collection",
        "queue",
        "capacity",
        "status",
        "error",
        "nan_policy",
        "watchdog_timeout_s",
        "step_timeout_s",
        "last_activity",
        "ingested",
        "processed",
        "sheds",
        "seq",
        "last_seq",
        "applied_seq",
        "durable_seq",
        "dupes",
    )

    def __init__(
        self,
        tenant_id: str,
        collection: Any,
        *,
        capacity: int,
        nan_policy: str,
        watchdog_timeout_s: Optional[float],
        step_timeout_s: Optional[float],
        seq: int,
    ) -> None:
        self.id = tenant_id
        self.collection = collection
        self.queue: deque = deque()
        self.capacity = capacity
        self.status = TenantStatus.ACTIVE
        self.error: Optional[BaseException] = None
        self.nan_policy = nan_policy
        self.watchdog_timeout_s = watchdog_timeout_s
        self.step_timeout_s = step_timeout_s
        self.last_activity = time.monotonic()
        self.ingested = 0
        self.processed = 0
        self.sheds = 0
        self.seq = seq
        # wire-sequence bookkeeping: highest client sequence
        # number ADMITTED to the queue (the dedup watermark — a replayed
        # submit at or below it is acknowledged without re-applying),
        # highest APPLIED into the collection (worker thread only), and
        # highest covered by a published checkpoint (the durable
        # watermark an ack reports so clients can prune replay buffers).
        # All 0 for tenants never driven over the wire (seq=None submits
        # leave them untouched).
        self.last_seq = 0
        self.applied_seq = 0
        self.durable_seq = 0
        self.dupes = 0


class TenantHandle:
    """Client-side handle to one attached tenant.

    Thread-safe: every method takes the daemon lock for its bookkeeping
    and never touches the device — ``submit`` enqueues, ``compute`` /
    ``detach`` enqueue a promise and block on the worker's answer. After a
    quarantine or eviction, every method raises the tenant's structured
    terminal error (:class:`~torcheval_tpu_torch.serve.TenantQuarantinedError` /
    :class:`~torcheval_tpu_torch.serve.TenantEvictedError`), so a producer loop
    finds out on its next call, with the reason attached.
    """

    __slots__ = ("_daemon", "_tenant")

    def __init__(self, daemon: Any, tenant: _Tenant) -> None:
        self._daemon = daemon
        self._tenant = tenant

    # ------------------------------------------------------------- queries
    @property
    def tenant_id(self) -> str:
        return self._tenant.id

    @property
    def status(self) -> TenantStatus:
        return self._tenant.status

    @property
    def error(self) -> Optional[BaseException]:
        """The structured terminal error (quarantine/eviction), if any."""
        return self._tenant.error

    # ---------------------------------------------------------------- ops
    def submit(
        self,
        *args: Any,
        block: bool = False,
        timeout: Optional[float] = None,
        seq: Optional[int] = None,
        stage: Any = None,
        gapless: bool = False,
    ) -> bool:
        """Enqueue one update batch (the metric ``update`` positional
        args). Returns once queued; the device work happens on the daemon
        worker. On a full queue: ``block=False`` sheds with
        :class:`~torcheval_tpu_torch.serve.BackpressureError` (reason
        ``"queue_full"``), ``block=True`` waits up to ``timeout`` seconds
        for space (then sheds). ``seq`` is the wire layer's per-tenant
        monotonic sequence number: a resubmit at or below the admitted
        watermark is acknowledged without re-applying (returns ``False``)
        — exactly-once into the metric state under at-least-once
        delivery. ``stage`` is the pooled staging buffer backing ``args``
        (the zero-copy ingest path); ownership transfers to the
        daemon, which releases it on EVERY path — after the batch's
        device placement, or immediately when the batch is deduplicated,
        shed, or dropped with a quarantined tenant. Returns ``True`` when
        the batch was admitted. ``gapless`` (the pipelined wire path)
        additionally refuses a ``seq`` past a still-unadmitted
        hole with a retryable ``seq_gap`` reject — see
        ``EvalDaemon._submit``."""
        return self._daemon._submit(
            self._tenant, args, block=block, timeout=timeout, seq=seq,
            stage=stage, gapless=gapless,
        )

    def flush(self, *, timeout: Optional[float] = None) -> dict:
        """Fold and checkpoint this tenant's current state WITHOUT
        evicting it: ``{"path": ckpt_dir, "acked_seq": durable_watermark}``.
        The wire client calls this to advance the durable watermark when
        its bounded replay buffer fills; local callers get a midstream
        resume point for free. The tenant stays ACTIVE and continues
        bit-identically."""
        return self._daemon._request(self._tenant, "flush", timeout=timeout)

    def compute(self, *, timeout: Optional[float] = None) -> Any:
        """Drain this tenant's queued batches, close its eval window and
        return the metric results (the collection's ``compute()`` shape).
        Blocks up to ``timeout`` seconds for the worker's answer."""
        return self._daemon._request(self._tenant, "compute", timeout=timeout)

    def sync_compute(
        self,
        *,
        timeout_s: Optional[float] = None,
        on_failure: str = "raise",
        timeout: Optional[float] = None,
    ) -> Any:
        """Cross-process ``sync_and_compute_collection`` of this tenant's
        metrics, run on the worker thread under the toolkit deadline contract
        (``timeout_s`` bounds the collective rounds; ``on_failure="local"``
        degrades to this rank's local results). The client blocks until the
        worker answers, which keeps multi-rank call order in lockstep —
        call it for the same tenants in the same order on every rank."""
        return self._daemon._request(
            self._tenant,
            "sync_compute",
            timeout=timeout,
            payload={"timeout_s": timeout_s, "on_failure": on_failure},
        )

    def detach(
        self, *, checkpoint: bool = False, timeout: Optional[float] = None
    ) -> Optional[str]:
        """Release this tenant's slot after the worker drains its queue.
        With ``checkpoint=True`` the state is folded and saved first
        (returns the checkpoint path — the graceful spelling of eviction);
        otherwise the state is dropped and ``None`` returns. Detaching an
        already-quarantined/evicted tenant just clears the slot."""
        return self._daemon._detach(
            self._tenant, checkpoint=checkpoint, timeout=timeout
        )

    def __repr__(self) -> str:
        t = self._tenant
        return (
            f"TenantHandle({t.id!r}, {t.status.value}, "
            f"queued={len(t.queue)})"
        )
