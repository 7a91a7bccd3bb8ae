"""Structured failure surface of the eval daemon.

JAX counterpart: ``torcheval_tpu/serve/errors.py``, ported whole: the same
classes, ``reason`` strings and ``retryable`` flags, because they cross the
wire between the two packages.

Every serve-side failure is an exception with a machine-readable
``.reason`` (the :class:`~torcheval_tpu_torch.resilience.CheckpointError`
pattern): a client can branch on the reason without parsing prose, and the
daemon's obs counters label by the same strings, so a dashboard and an
except-clause speak one vocabulary.

The hierarchy mirrors the tenant lifecycle:

* :class:`AdmissionError` — ``attach`` refused (``"capacity"``,
  ``"duplicate_tenant"``, ``"daemon_stopped"``, ``"bad_metrics"``,
  ``"no_checkpoint"``, ``"draining"``). Admission control is the front
  door of load shedding: a daemon at capacity rejects with a reason
  instead of growing an unbounded tenant table.
* :class:`BackpressureError` — a ``submit`` shed (``"queue_full"``): the
  tenant's bounded queue is full and the policy is reject-with-reason,
  never unbounded growth. Retry later, or submit with ``block=True``.
* :class:`TenantQuarantinedError` — the tenant was isolated after a fault
  its own stream caused (``"poisoned_batch"``, ``"nan_policy"``,
  ``"compute_error"``, ``"step_timeout"``); every other tenant proceeded.
  The original exception (if any) is ``__cause__``.
* :class:`TenantEvictedError` — the watchdog (or an explicit
  ``evict``/``detach(checkpoint=True)``) checkpointed the tenant's state
  and released its slot; ``.checkpoint`` is the directory to resume from
  (``attach(..., resume=...)`` restores it bit-identically).
* :class:`WireError` — the network layer's transport-level
  failures (``"transport"``, ``"request_timeout"``, ``"circuit_open"``,
  ``"protocol"``): the request may never have reached a daemon, so the
  *cluster* can retry it (idempotent submits make that safe), while the
  serve-side hierarchy above reports what a daemon decided.

Every error additionally carries ``retryable`` — the ONE retry
classification the wire client, the router and local callers all share:
``True`` means the same request can succeed later without operator
action (a shed under load, a daemon transiently at capacity, a network
blip), ``False`` means retrying is wrong (a quarantine, a duplicate id,
a bad metric spec) and the caller must change something first. The wire
layer marshals the flag with the error, so a remote client branches on
exactly the bit a local caller would.
"""

from __future__ import annotations

from typing import Optional

__all__ = [
    "ServeError",
    "AdmissionError",
    "BackpressureError",
    "TenantError",
    "TenantQuarantinedError",
    "TenantEvictedError",
    "WireError",
]


class ServeError(RuntimeError):
    """Base class: every serve failure carries a machine-readable
    ``reason`` alongside the human message, plus ``retryable`` — whether
    the same request can succeed later without the caller changing
    anything (the shared retry-classification source of truth)."""

    # reasons (per concrete class) for which an identical retry can
    # succeed once load drains; everything else needs caller action
    _RETRYABLE_REASONS: frozenset = frozenset()

    def __init__(self, reason: str, message: str) -> None:
        super().__init__(f"[{reason}] {message}")
        self.reason = reason
        self.retryable = reason in self._RETRYABLE_REASONS


class AdmissionError(ServeError):
    """``attach`` refused at the front door (see module doc for reasons).

    Only ``"capacity"`` is retryable: the daemon is full NOW but a
    detach/eviction frees a slot. A duplicate id, a bad metric spec, a
    stopped or draining daemon, or a missing required checkpoint will
    reject an identical retry forever."""

    _RETRYABLE_REASONS = frozenset({"capacity"})


class BackpressureError(ServeError):
    """A ``submit`` was shed: the tenant's bounded queue is full.

    ``tenant`` names the shedding tenant. The queue bound is the
    load-shedding contract — ingestion never grows without bound, the
    producer is told *why* (``reason="queue_full"``) and can back off,
    block (``submit(..., block=True)``) or drop. Always retryable:
    a shed is by definition a transient load condition.
    """

    def __init__(self, reason: str, message: str, *, tenant: str) -> None:
        super().__init__(reason, message)
        self.tenant = tenant
        self.retryable = True


class TenantError(ServeError):
    """Base for per-tenant terminal states; ``tenant`` names the tenant."""

    def __init__(self, reason: str, message: str, *, tenant: str) -> None:
        super().__init__(reason, message)
        self.tenant = tenant


class TenantQuarantinedError(TenantError):
    """The tenant was quarantined: a fault its own stream caused (poisoned
    batch, NaN-policy violation, a compute that raised, or a step that
    outran its deadline) isolated it with this error while every other
    tenant proceeded. Its accumulated state is considered suspect and is
    NOT checkpointed; ``detach`` the handle and re-``attach`` to start
    clean. The triggering exception, when there was one, is ``__cause__``.
    """


class TenantEvictedError(TenantError):
    """The tenant's slot was reclaimed after its state was checkpointed.

    ``checkpoint`` is the checkpoint directory
    (``<evict_dir>/<tenant_id>``); ``attach`` the same tenant id with
    identically-configured metrics and ``resume="auto"``/``"require"`` to
    restore and continue bit-identically.
    """

    def __init__(
        self,
        reason: str,
        message: str,
        *,
        tenant: str,
        checkpoint: Optional[str] = None,
    ) -> None:
        super().__init__(reason, message, tenant=tenant)
        self.checkpoint = checkpoint


class WireError(ServeError):
    """A network-layer failure between an :class:`EvalClient` and a host.

    Reasons: ``"transport"`` (connect/send/recv failed or the connection
    died mid-request — the request may or may not have been processed;
    idempotent submits make a blind retry safe), ``"request_timeout"``
    (no response within the per-request deadline), ``"circuit_open"``
    (this host's breaker is open after consecutive failures — fail fast
    without touching the socket), ``"protocol"`` (unparseable frame: a
    version skew or a stray speaker on the port — NOT retryable, the
    peer will stay wrong). ``endpoint`` names the host. Transport-family
    failures are retryable *against the cluster*: the router responds to
    them by migrating the host's tenants, not by hammering the dead
    host.
    """

    _RETRYABLE_REASONS = frozenset(
        {"transport", "request_timeout", "circuit_open"}
    )

    def __init__(
        self, reason: str, message: str, *, endpoint: Optional[str] = None
    ) -> None:
        super().__init__(reason, message)
        self.endpoint = endpoint
