"""`EvalDaemon`: a fault-contained multi-tenant eval front end.

JAX counterpart: ``torcheval_tpu/serve/daemon.py``. The scheduler, the
admission and containment rules, eviction and the health reports are the
same; what differs is the device. A daemon serves ONE torch device,
``cuda:0`` unless the caller asks for another (``device="cpu"`` runs on the
CPU; with no GPU the default raises). Metrics built from a wire spec are
built on it, and an in-process ``attach`` of metrics that live elsewhere is
refused (``bad_metrics``). The worker thread enters the device once and
runs every tenant's kernels on its current stream; the staging pass copies
each coalesced group on the daemon's own copy stream from pinned memory
(``ingest.py``), so window N+1's bytes can move while window N's step runs.

One long-running daemon owns the device and serves many concurrent
eval streams (*tenants*), each backed by its own
:class:`~torcheval_tpu_torch.metrics.MetricCollection`. The topology is the
decoupled many-producers / one-device-consumer shape of Podracer
(arXiv:2104.06272): any number of client threads enqueue host batches into
bounded per-tenant queues; ONE worker thread drains them and drives the
collections, so every device dispatch is serialized through a single
owner and a tenant can never corrupt another tenant's device work.

**Robustness is the headline property** — no tenant can take down the
daemon or another tenant:

* **Admission control** (``attach``): a daemon at ``max_tenants`` rejects
  with a structured :class:`AdmissionError` instead of growing without
  bound; duplicate ids and stopped daemons reject the same way.
* **Backpressure** (``submit``): per-tenant queues are bounded; a full
  queue sheds with :class:`BackpressureError` (reason ``"queue_full"``) —
  reject-with-reason, never unbounded growth. ``block=True`` opts into
  bounded waiting instead.
* **Fault containment**: a poisoned batch (bad shape/dtype surfacing in
  update validation, or a NaN under ``nan_policy="reject"``) or a compute
  that raises quarantines THAT tenant with a structured
  :class:`TenantQuarantinedError`; the worker moves on and every other
  tenant's results are untouched (proven bit-identical against fault-free
  oracles in ``tests/serve/``). A quarantined tenant's state is suspect
  and is never checkpointed.
* **Watchdog eviction**: a tenant idle past its ``watchdog_timeout_s`` is
  *evicted* — its state folds and checkpoints atomically via
  ``resilience.save`` into ``<evict_dir>/<tenant_id>`` and its slot frees;
  re-``attach`` with ``resume="auto"`` restores the checkpoint and the
  stream continues bit-identically. ``step_timeout_s`` additionally arms
  the toolkit watchdog (``toolkit._sync_deadline`` + ``_run_guarded``) around
  each tenant's device step; a step that outruns it quarantines the tenant
  (the abandoned dispatch may still write its states later, so that state
  must never be checkpointed as truth — eviction is reserved for cleanly
  folded state).

**Batch coalescing.** Tenants whose batches share one ``(shape, dtype)``
signature are served back-to-back, and their queued host batches move to
the device in one copy per signature group (``ingest.coalesce_h2d``). The
scheduler runs control work (compute/detach)
FIRST — the per-tenant fallback lane: coalescing is opportunistic and
never delays a tenant's result to wait for a group.

Per-tenant observability: ``serve.ingest.batches{tenant=}`` /
``serve.ingest.sheds{tenant=,reason=}`` / ``serve.quarantines`` /
``serve.evictions`` counters, a ``serve.queue_depth{tenant=}`` occupancy
histogram, and a ``serve.tenant.step{tenant=}`` span per worker pass (the
rank-tagged tenant bars in the Chrome trace). ``health()`` returns a
structured daemon snapshot; ``health(sync=True)`` merges every rank's view
over ``obs.sync_snapshot()``'s one-collective exchange.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from torcheval_tpu_torch.obs import registry as _obs
from torcheval_tpu_torch.obs import trace as _trace
from torcheval_tpu_torch.resilience import chaos as _chaos
from torcheval_tpu_torch.serve.errors import (
    AdmissionError,
    BackpressureError,
    ServeError,
    TenantEvictedError,
    TenantQuarantinedError,
)
from torcheval_tpu_torch.serve.tenant import (
    TenantHandle,
    TenantStatus,
    _Promise,
    _Tenant,
)
from torcheval_tpu_torch.utils.devices import DeviceLike, canonical_device

_logger = logging.getLogger(__name__)

__all__ = ["EvalDaemon"]

_NAN_POLICIES = ("propagate", "reject")
_RESUME_POLICIES = ("auto", "never", "require")


class _NaNPolicyViolation(ValueError):
    """Internal: a float batch carried NaN under ``nan_policy="reject"``."""


def _ingest_anchor(device: torch.device):
    """An event recorded on the worker's current stream of ``device`` —
    the guard a dropped batch's staging buffer is released on, so its slot
    is not recycled before every piece of work enqueued so far has run.
    ``None`` on the CPU, where nothing is in flight. (The deferred
    window's own event is recorded only while obs is enabled, so it cannot
    be this anchor.)"""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def _collection_device(collection) -> Optional[torch.device]:
    """The one ``torch.device`` a collection's deferring members place
    batches on, or ``None`` (no deferring member, or a probe without a
    plain device): the staging pass's gate."""
    probe = getattr(collection, "_defer_probe", None)
    device = getattr(probe, "_device", None)
    return device if isinstance(device, torch.device) else None


def _batch_signature(args) -> tuple:
    """Host-side batch signature for coalesced scheduling: shapes + dtypes
    of the queued (host) arrays. Cheap — attribute reads only."""
    return tuple(
        (
            tuple(getattr(a, "shape", ()) or ()),
            str(getattr(a, "dtype", type(a).__name__)),
        )
        for a in args
    )


class EvalDaemon:
    """The persistent multi-tenant eval service (see module doc).

    Example::

        from torcheval_tpu_torch.serve import EvalDaemon
        from torcheval_tpu_torch.metrics import MulticlassAccuracy

        with EvalDaemon(max_tenants=128) as daemon:
            h = daemon.attach("user-42", {"acc": MulticlassAccuracy(num_classes=10)})
            for scores, labels in stream:
                h.submit(scores, labels)       # async, bounded, shed-with-reason
            results = h.compute()              # {"acc": ...}
            h.detach()

    ``start()``/``stop()`` (or the context manager) bound the worker
    thread's lifetime. All client methods are thread-safe.
    """

    def __init__(
        self,
        *,
        max_tenants: int = 64,
        queue_capacity: int = 32,
        evict_dir: Optional[str] = None,
        evict_keep_last: int = 2,
        watchdog_interval_s: float = 0.25,
        metrics_port: Optional[int] = None,
        device: DeviceLike = None,
    ) -> None:
        if max_tenants < 1:
            raise ValueError(f"max_tenants must be >= 1, got {max_tenants}.")
        if queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1, got {queue_capacity}."
            )
        # the one device every tenant's metrics live on (module doc)
        self._device = canonical_device(device)
        # the staging pass's pinned slots and its copy stream (CUDA only)
        from torcheval_tpu_torch.serve.ingest import HostBufferPool

        self._stage_pool = HostBufferPool(device=self._device)
        self._copy_stream = (
            torch.cuda.Stream(device=self._device)
            if self._device.type == "cuda"
            else None
        )
        self._max_tenants = max_tenants
        self._queue_capacity = queue_capacity
        self._evict_dir_arg = evict_dir
        self._evict_dir: Optional[str] = evict_dir
        self._evict_keep_last = evict_keep_last
        self._watchdog_interval_s = watchdog_interval_s
        # metrics_port: bind the stdlib Prometheus/health scrape endpoint
        # (obs/httpd.py) on start(); 0 = ephemeral port, None = no endpoint
        self._metrics_port = metrics_port
        self._metrics_server = None
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._tenants: Dict[str, _Tenant] = {}
        self._attaching: set = set()  # reserved ids mid-admission
        self._running = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        self._started_at: Optional[float] = None
        self._totals = {"attached": 0, "quarantined": 0, "evicted": 0}
        # aggregate submit/step latency EWMAs (alpha below) feeding
        # load_report(); plain floats, no registry round trip
        self._lat_ewma: Dict[str, float] = {}
        # callbacks the wire layer registers to get a final obs push out
        # before telemetry consumers would otherwise see a silent stop
        self._flush_hooks: list = []

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "EvalDaemon":
        with self._cond:
            if self._running:
                return self
            self._running = True
            self._started_at = time.monotonic()
            self._thread = threading.Thread(
                target=self._worker_loop,
                name="torcheval-tpu-serve-worker",
                daemon=True,
            )
            self._thread.start()
        if self._metrics_port is not None and self._metrics_server is None:
            from torcheval_tpu_torch.obs.httpd import MetricsServer

            self._metrics_server = MetricsServer(
                port=self._metrics_port,
                health_provider=self.load_report,
            ).start()
        return self

    @property
    def device(self) -> torch.device:
        """The device this daemon serves (every tenant's metrics live on
        it; wire specs are built on it)."""
        return self._device

    @property
    def metrics_address(self) -> Optional[tuple]:
        """``(host, port)`` of the scrape endpoint, or ``None`` when the
        daemon was built without ``metrics_port``."""
        if self._metrics_server is None:
            return None
        return self._metrics_server.address

    def stop(self, *, timeout: Optional[float] = 10.0) -> None:
        """Stop the worker. Outstanding compute/detach promises are failed
        with a structured ``daemon_stopped`` error; tenant tables stay
        readable (``health()``) but every handle op raises afterwards.
        ``timeout`` bounds the worker join (``None`` = wait forever) and
        is validated at this boundary like every other deadline knob — a
        NaN/inf/non-positive join budget must raise here, not silently
        turn the join into a no-op or a hang."""
        from torcheval_tpu_torch.metrics.toolkit import _check_timeout_s

        _check_timeout_s(timeout)
        with self._cond:
            if not self._running:
                return
            self._running = False
            self._cond.notify_all()
        # final obs flush BEFORE the worker join: subscribers get the last
        # delta (including this stop's own instruments) while the wire
        # publishers are still alive
        self._notify_flush_hooks()
        if self._thread is not None:
            self._thread.join(timeout)
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None

    # ---------------------------------------------------------- flush hooks
    def _add_flush_hook(self, cb) -> None:
        """Register ``cb()`` to run on ``drain()`` and ``stop()`` — the
        obs push channel's final-flush seam (``wire.EvalServer`` wires its
        publishers here so a subscriber's last delta is never lost to a
        graceful shutdown)."""
        with self._lock:
            if cb not in self._flush_hooks:
                self._flush_hooks.append(cb)

    def _remove_flush_hook(self, cb) -> None:
        with self._lock:
            try:
                self._flush_hooks.remove(cb)
            except ValueError:
                pass

    def _notify_flush_hooks(self) -> None:
        with self._lock:
            hooks = list(self._flush_hooks)
        for cb in hooks:
            try:
                cb()
            except Exception:  # noqa: BLE001 - shutdown must proceed
                _logger.exception("serve: obs flush hook raised; continuing")

    def __enter__(self) -> "EvalDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ admission
    def attach(
        self,
        tenant_id: str,
        metrics: Any,
        *,
        nan_policy: str = "propagate",
        watchdog_timeout_s: Optional[float] = None,
        step_timeout_s: Optional[float] = None,
        queue_capacity: Optional[int] = None,
        resume: str = "auto",
        window_chunks: Optional[int] = None,
        approx=None,
        slices=None,
    ) -> TenantHandle:
        """Admit one tenant and return its handle.

        ``metrics`` is a ``Metric``, a ``{name: Metric}`` dict, or a
        prebuilt ``MetricCollection`` — the tenant's whole eval stream
        folds through it. ``nan_policy="reject"`` quarantines the tenant
        on the first float batch carrying NaN (an O(batch) host scan per
        submit-side batch, priced in docs). ``watchdog_timeout_s`` arms
        idle eviction; ``step_timeout_s`` arms the per-step toolkit watchdog.
        ``resume`` controls eviction-checkpoint restore for this tenant id:
        ``"auto"`` restores iff a checkpoint exists, ``"require"`` raises
        ``AdmissionError(reason="no_checkpoint")`` without one, ``"never"``
        starts clean. ``window_chunks`` caps this tenant's eval-window
        occupancy (the deferred chunk-count valve): a lower cap closes
        windows more often, which bounds per-tenant pending HBM and sets
        the double-buffering cadence — window N+1 fills and transfers
        while window N's step executes. ``approx`` (ROADMAP
        4(c)) opts this tenant's curve/cache metrics into bounded-memory
        sketch state (``True`` = family-default bucket count, an int = the
        bucket count — the metric constructors' ``approx=`` contract,
        applied at admission): every member with an approx mode switches;
        members whose state is already bounded (counters, regressions,
        ``Quantile``) pass through, and a spec where NO member has an
        approx mode — or where a member supports it but cannot switch
        (already-streamed state, a multiclass curve without
        ``num_classes``) — rejects as ``bad_metrics``. A tenant re-attached
        with a different ``approx`` than its eviction checkpoint cannot
        restore into the changed state schema — use ``resume="never"`` to
        start it clean. ``slices`` opts this tenant into
        per-cohort eval: ``True`` (defaults), an int (initial dense
        capacity), or ``{"capacity": int, "curve_bucket_bits": int,
        "mesh_axis": str}`` — the tenant's metrics become a
        :class:`~torcheval_tpu_torch.metrics.SlicedMetricCollection`, every
        ``submit`` must carry the ``slice_ids`` integer column FIRST, and
        ``compute`` returns per-slice results keyed by original ids.
        ``slices={"mesh_axis": ...}`` additionally shards the
        slice axis of every member state across that named dim of a flat
        one-dim ``DeviceMesh`` over the ``torch.distributed`` world (which
        must be initialised) — per-rank slice state shrinks by the world
        size (the axis name is a plain wire string; device handles never
        cross the wire). Every member must live on the daemon's device. The
        sliceability of every member is validated BEFORE the ``approx``
        knob commits (validate-then-commit covers slice expansion too): a
        spec with an unsliceable member rejects as ``bad_metrics`` without
        half-switching anything. Raises :class:`AdmissionError`
        (``"capacity"`` / ``"duplicate_tenant"`` / ``"daemon_stopped"`` /
        ``"bad_metrics"``) instead of ever over-admitting.
        """
        if nan_policy not in _NAN_POLICIES:
            raise ValueError(
                f"nan_policy must be one of {_NAN_POLICIES}, got {nan_policy!r}."
            )
        if resume not in _RESUME_POLICIES:
            raise ValueError(
                f"resume must be one of {_RESUME_POLICIES}, got {resume!r}."
            )
        # the same boundary validation the sync APIs perform: a degenerate
        # deadline must reject ADMISSION, not fire later inside the worker
        # (where a ValueError from the deadline machinery would be
        # misclassified as tenant poison) or silently disarm the watchdog
        # (nan never compares >= the idle age)
        from torcheval_tpu_torch.metrics.toolkit import _check_timeout_s

        for knob, value in (
            ("watchdog_timeout_s", watchdog_timeout_s),
            ("step_timeout_s", step_timeout_s),
        ):
            try:
                _check_timeout_s(value)
            except ValueError as e:
                raise ValueError(f"{knob}: {e}") from None
        if queue_capacity is not None and queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1, got {queue_capacity}."
            )
        if window_chunks is not None and (
            not isinstance(window_chunks, int) or window_chunks < 1
        ):
            raise ValueError(
                f"window_chunks must be an int >= 1, got {window_chunks!r}."
            )
        with self._cond:
            if not self._running:
                self._count_admission("rejected", "daemon_stopped")
                raise AdmissionError(
                    "daemon_stopped",
                    f"cannot attach {tenant_id!r}: the daemon is not running.",
                )
            if self._draining:
                self._count_admission("rejected", "draining")
                raise AdmissionError(
                    "draining",
                    f"cannot attach {tenant_id!r}: this daemon is draining "
                    "(its tenants are being migrated off-host).",
                )
            if tenant_id in self._tenants or tenant_id in self._attaching:
                self._count_admission("rejected", "duplicate_tenant")
                raise AdmissionError(
                    "duplicate_tenant",
                    f"tenant {tenant_id!r} is already attached; detach it "
                    "first.",
                )
            if (
                len(self._tenants) + len(self._attaching)
                >= self._max_tenants
            ):
                self._count_admission("rejected", "capacity")
                raise AdmissionError(
                    "capacity",
                    f"daemon is at max_tenants={self._max_tenants}; "
                    f"rejecting {tenant_id!r} (load shedding at the front "
                    "door — retry after a detach/eviction).",
                )
            # a malformed slices config raises a raw ValueError (knob
            # validation, not spec rejection); build_collection
            # re-normalizes inside
            self._normalize_slices(slices)
            try:
                self._check_devices(metrics)
                collection = self.build_collection(
                    metrics,
                    slices=slices,
                    approx=approx,
                    window_chunks=window_chunks,
                )
            except ValueError as e:
                self._count_admission("rejected", "bad_metrics")
                raise AdmissionError(
                    "bad_metrics", f"tenant {tenant_id!r} {e}"
                ) from e
            ckpt_dir = self._tenant_ckpt_dir(tenant_id, create=False)
            # reserve the id + a capacity slot, then RELEASE the lock for
            # the checkpoint I/O below: a migration restore can take long
            # enough that holding the daemon-wide lock across it would
            # stall every live tenant's submit on this host
            self._attaching.add(tenant_id)
        do_resume = False
        resumed_seq = 0
        try:
            if resume != "never":
                from torcheval_tpu_torch.resilience.snapshot import latest_checkpoint

                has_ckpt = (
                    ckpt_dir is not None
                    and latest_checkpoint(ckpt_dir) is not None
                )
                if resume == "require" and not has_ckpt:
                    self._count_admission("rejected", "no_checkpoint")
                    raise AdmissionError(
                        "no_checkpoint",
                        f"resume='require' but no eviction checkpoint exists "
                        f"for tenant {tenant_id!r} under {ckpt_dir!r}.",
                    )
                do_resume = has_ckpt
            if do_resume:
                # restore BEFORE the tenant is visible: a failed restore
                # (schema drift) must reject admission, not quarantine a
                # half-born tenant. Corrupt BYTES are different:
                # a bit-flipped generation is quarantined and the
                # walk falls back to the previous durable one — the
                # tenant degrades to an older watermark and the client
                # replay buffer heals the gap, instead of the whole
                # attach rejecting over storage rot.
                from torcheval_tpu_torch.resilience.snapshot import (
                    _CORRUPT_REASONS,
                    CheckpointError,
                    _resolve_ckpt,
                    quarantine_checkpoint,
                    read_extra,
                    restore,
                )

                fell_back = 0
                while True:
                    # resolve the checkpoint ONCE per attempt and use the
                    # same directory for both the state and the watermark
                    # — resolving twice would let a concurrent publish
                    # (e.g. a partitioned old host still flushing into
                    # the shared root) slip a newer manifest between the
                    # two reads, arming the dedup window ahead of the
                    # restored state and silently dropping replayed
                    # batches. For seq-tracked tenants prefer the HIGHEST
                    # acked watermark over the newest step: a
                    # partitioned-but-alive old host can publish a stale
                    # checkpoint into the shared root AFTER the tenant
                    # migrated, and "newest step" would resurrect it.
                    try:
                        ckpt = self._best_serve_ckpt(
                            ckpt_dir
                        ) or _resolve_ckpt(ckpt_dir)
                    except CheckpointError:
                        ckpt = None
                    if ckpt is None:
                        # the lineage ran dry: every generation was
                        # corrupt and is now quarantined. "require"
                        # promised a restorable checkpoint — reject;
                        # "auto" degrades to a clean start (the replay
                        # buffer is the only healer left).
                        if resume == "require":
                            self._count_admission(
                                "rejected", "no_checkpoint"
                            )
                            raise AdmissionError(
                                "no_checkpoint",
                                f"resume='require' but every checkpoint "
                                f"generation for tenant {tenant_id!r} "
                                f"under {ckpt_dir!r} was corrupt "
                                f"({fell_back} quarantined).",
                            )
                        do_resume = False
                        break
                    try:
                        restore(collection, ckpt)
                    except CheckpointError as e:
                        if e.reason not in _CORRUPT_REASONS:
                            raise
                        quarantine_checkpoint(ckpt)
                        fell_back += 1
                        continue
                    # the wire-sequence watermark rides the manifest
                    # (written atomically with the state it describes):
                    # every batch with seq <= resumed_seq is IN the
                    # restored state, so the dedup window re-arms exactly
                    # where the checkpoint left it and a client replaying
                    # its un-acked window after a migration can never
                    # double-apply a checkpointed batch
                    resumed_seq = int(
                        read_extra(ckpt).get("serve", {}).get("acked_seq", 0)
                    )
                    if fell_back and _obs._enabled:
                        _obs.counter(
                            "resilience.checkpoint.fallback_restores"
                        )
                    break
        except BaseException:
            with self._cond:
                self._attaching.discard(tenant_id)
            raise
        with self._cond:
            self._attaching.discard(tenant_id)
            if not self._running or self._draining:
                # the daemon stopped/drained while we restored: reject —
                # committing now would strand a tenant the drain's
                # eviction sweep already missed
                reason = "daemon_stopped" if not self._running else "draining"
                self._count_admission("rejected", reason)
                raise AdmissionError(
                    reason,
                    f"cannot attach {tenant_id!r}: the daemon began "
                    f"{reason.replace('_', ' ')} during admission.",
                )
            self._seq += 1
            tenant = _Tenant(
                tenant_id,
                collection,
                capacity=(
                    queue_capacity
                    if queue_capacity is not None
                    else self._queue_capacity
                ),
                nan_policy=nan_policy,
                watchdog_timeout_s=watchdog_timeout_s,
                step_timeout_s=step_timeout_s,
                seq=self._seq,
            )
            tenant.last_seq = tenant.applied_seq = tenant.durable_seq = (
                resumed_seq
            )
            self._tenants[tenant_id] = tenant
            self._totals["attached"] += 1
            self._count_admission("accepted", "resumed" if do_resume else "new")
            if _obs._enabled:
                _obs.gauge("serve.tenants.active", float(len(self._tenants)))
        return TenantHandle(self, tenant)

    def _check_devices(self, metrics) -> None:
        """Refuse metrics that live on another device than the daemon's
        (checked before anything is switched or built): they would be
        served where they happen to be, off the daemon's worker stream and
        staging path."""
        members = getattr(metrics, "metrics", metrics)
        if not isinstance(members, dict):
            members = {"metric": members}
        for name, m in members.items():
            device = getattr(m, "device", None)
            if device != self._device:
                raise ValueError(
                    f"metric {name!r} lives on {device}, but this daemon "
                    f"serves {self._device}; build the metrics with "
                    f"device={str(self._device)!r}."
                )

    @staticmethod
    def build_collection(
        metrics,
        *,
        slices=None,
        approx=None,
        window_chunks=None,
    ):
        """Construct the servable collection EXACTLY as attach admission
        does — the ONE constructor shared by daemon admission and the
        router's split-tenant merged compute (a replica's
        flush checkpoint restores only into an identically-built
        collection, so the merge path must never re-implement this).
        Order matters and is the admission contract: sliceability dry
        pass BEFORE the ``approx`` knob commits (validate-then-commit
        covers slice-expanded members), then the sketch switch, then the
        slice expansion, then the per-instance window valve. Raises
        ``ValueError`` carrying the admission message tail; ``attach``
        prefixes the tenant id and wraps it as
        ``AdmissionError("bad_metrics")``."""
        from torcheval_tpu_torch.metrics.collection import MetricCollection

        try:
            collection = (
                metrics
                if isinstance(metrics, MetricCollection)
                else MetricCollection(metrics)
            )
        except (TypeError, ValueError) as e:
            raise ValueError(f"metrics are not servable: {e}") from e
        slice_cfg = EvalDaemon._normalize_slices(slices)
        from torcheval_tpu_torch.metrics.sliced import (
            SlicedMetricCollection,
            check_sliceable,
        )

        if slice_cfg is not None and not isinstance(
            collection, SlicedMetricCollection
        ):
            # sliceability dry pass BEFORE the approx knob commits:
            # validate-then-commit must cover slice-expanded members
            # too — a spec with one unsliceable member rejects here
            # without any member having been switched to sketch state
            try:
                for m in collection.metrics.values():
                    check_sliceable(m, approx=approx)
            except ValueError as e:
                raise ValueError(
                    f"cannot run slices={slices!r}: {e}"
                ) from e
        if approx is not None and approx is not False:
            # per-tenant sketch opt-in (ROADMAP 4(c)): switch every
            # approx-capable member at admission; reject when the spec
            # has no capable member or a member cannot switch.
            # Validate-then-commit: the dry pass runs EVERY member's
            # checks before anything mutates, so a rejection never
            # leaves a caller-held instance half-switched into a
            # changed state schema.
            from torcheval_tpu_torch.sketch.cache import enable_metric_approx

            try:
                capable = [
                    enable_metric_approx(m, approx, dry_run=True)
                    for m in collection.metrics.values()
                ]
            except ValueError as e:
                raise ValueError(
                    f"cannot run approx={approx!r}: {e}"
                ) from e
            if not any(capable):
                raise ValueError(
                    f"asked for approx={approx!r} but no metric in its "
                    "spec has an approx mode."
                )
            for m in collection.metrics.values():
                enable_metric_approx(m, approx)
        if slice_cfg is not None and not isinstance(
            collection, SlicedMetricCollection
        ):
            try:
                if "mesh_axis" in slice_cfg:
                    slice_cfg = dict(slice_cfg)
                    slice_cfg["mesh"] = EvalDaemon._slice_mesh(
                        collection, slice_cfg["mesh_axis"]
                    )
                collection = SlicedMetricCollection(
                    collection.metrics, **slice_cfg
                )
            except ValueError as e:
                raise ValueError(
                    f"cannot run slices={slices!r}: {e}"
                ) from e
        if window_chunks is not None:
            # per-instance valve override (the collection's budget
            # check reads the probe member; each member's own 2x
            # self-valve scales off the same attribute)
            for m in getattr(collection, "_deferred", {}).values():
                m._DEFER_MAX_CHUNKS = window_chunks
        return collection

    @staticmethod
    def _slice_mesh(collection, axis: str):
        """The flat one-dim ``DeviceMesh`` named ``axis`` over the whole
        ``torch.distributed`` world, on the members' device type."""
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise ValueError(
                f"slices mesh_axis={axis!r} shards over the torch.distributed "
                "world, which is not initialised in this process."
            )
        from torch.distributed.device_mesh import init_device_mesh

        device = next(iter(collection.metrics.values())).device
        return init_device_mesh(
            device.type, (dist.get_world_size(),), mesh_dim_names=(axis,)
        )

    @staticmethod
    def _normalize_slices(slices) -> Optional[dict]:
        """``slices`` knob → SlicedMetricCollection kwargs (or ``None`` =
        unsliced). ``True`` = defaults, an int = initial dense capacity, a
        dict allows ``capacity`` / ``curve_bucket_bits`` / ``mesh_axis``
        (a string axis NAME — it travels the wire as plain JSON and the
        daemon builds the flat mesh over the process world, so a
        client never ships device handles). Validated at the admission
        boundary so a typo'd config rejects the attach instead of
        surfacing later as tenant poison."""
        if slices is None or slices is False:
            return None
        if slices is True:
            return {}
        if isinstance(slices, int):
            return {"capacity": slices}
        if isinstance(slices, dict):
            allowed = {"capacity", "curve_bucket_bits", "mesh_axis"}
            unknown = set(slices) - allowed
            if unknown:
                raise ValueError(
                    f"unknown slices config keys {sorted(unknown)}; "
                    f"allowed: {sorted(allowed)}."
                )
            out = {}
            for k, v in slices.items():
                if k == "mesh_axis":
                    if not isinstance(v, str) or not v:
                        raise ValueError(
                            "slices['mesh_axis'] must be a non-empty "
                            f"axis-name string, got {v!r}."
                        )
                    out[k] = v
                else:
                    out[k] = int(v)
            return out
        raise ValueError(
            "slices must be True, an int capacity, or a config dict, "
            f"got {slices!r}."
        )

    @staticmethod
    def _best_serve_ckpt(ckpt_dir: Optional[str]) -> Optional[str]:
        """The published checkpoint with the highest serve acked-seq
        watermark (ties -> newest step; zero-padded names sort by step).
        For tenants never driven over the wire every watermark is 0 and
        this degenerates to newest-step, exactly the old behavior."""
        from torcheval_tpu_torch.resilience.snapshot import (
            CheckpointError,
            list_checkpoints,
            read_extra,
        )

        if ckpt_dir is None:
            return None
        best, best_key = None, None
        for ckpt in list_checkpoints(ckpt_dir):
            try:
                acked = int(
                    read_extra(ckpt).get("serve", {}).get("acked_seq", 0)
                )
            except (CheckpointError, TypeError, ValueError):
                continue  # unreadable manifest: restore would reject it
            key = (acked, ckpt)
            if best_key is None or key > best_key:
                best, best_key = ckpt, key
        return best

    def _count_admission(self, result: str, reason: str) -> None:
        if _obs._enabled:
            _obs.counter("serve.admissions", result=result, reason=reason)

    def _tenant_ckpt_dir(
        self, tenant_id: str, *, create: bool
    ) -> Optional[str]:
        if self._evict_dir is None:
            if not create and self._evict_dir_arg is None:
                # no directory configured and none materialized yet: there
                # can be no checkpoint to resume from
                return None
            self._evict_dir = self._evict_dir_arg or tempfile.mkdtemp(
                prefix="torcheval_tpu_serve_evict_"
            )
        # tenant ids become directory names; keep them filesystem-safe
        safe = "".join(
            c if (c.isalnum() or c in "-_.") else "_" for c in tenant_id
        )
        return os.path.join(self._evict_dir, safe)

    # ------------------------------------------------------------ ingestion
    def _submit(
        self,
        tenant: _Tenant,
        args: tuple,
        *,
        block: bool,
        timeout: Optional[float],
        seq: Optional[int] = None,
        stage: Any = None,
        gapless: bool = False,
    ) -> bool:
        """Admit one batch. ``seq`` is the wire client's per-tenant
        monotonic sequence number: a submit at or below the tenant's
        admitted watermark is a replay of a batch this daemon already
        holds (an ambiguous-failure retry — at-least-once on the wire)
        and is acknowledged WITHOUT re-applying (exactly-once into the
        metric state). Returns ``True`` when the batch was admitted,
        ``False`` when it was deduplicated. The dedup check re-runs
        after every capacity wait: two retries of one seq can block in
        the wait side by side, and only the first may append.

        ``stage`` (the pooled staging buffer backing ``args``)
        is owned by this call from here on: it rides the queue entry and
        is released after the worker's device placement, or released
        RIGHT HERE on every path that does not enqueue (dedup, shed,
        drain reject, dead tenant) — a shed batch must never leak its
        staging slot.

        ``gapless`` (set by the pipelined wire path) enforces
        contiguous per-tenant admission: a ``seq`` ABOVE ``last admitted
        + 1`` is refused with a retryable ``seq_gap`` reject instead of
        admitted. With several frames of one tenant in flight at once,
        admitting past a hole (an earlier seq that shed) would ratchet
        the dedup watermark over it — the eventual replay of the missing
        seq would then read as a duplicate and be silently swallowed.
        The refusal makes every out-of-order interleaving self-healing:
        nothing lands past the hole, the client's resend redelivers the
        tail in order. Lock-step submits never set it (they are
        contiguous by construction, and migration tests drive fresh
        daemons at restored watermarks the daemon never saw)."""
        t0 = time.perf_counter()
        deadline = (
            time.monotonic() + timeout
            if (block and timeout is not None)
            else None
        )
        try:
            with self._cond:
                while True:
                    self._check_live(tenant)
                    if seq is not None and seq <= tenant.last_seq:
                        # dedup BEFORE the draining check: a replay of an
                        # already-admitted seq must get its duplicate ack
                        # even mid-drain — a "draining" reject here would
                        # make the client think the batch was never admitted
                        # and resubmit it under a fresh seq elsewhere while
                        # the drain checkpoint also carries it (double-apply)
                        tenant.dupes += 1
                        if _obs._enabled:
                            _obs.counter(
                                "serve.ingest.dupes", tenant=tenant.id
                            )
                        return False
                    if (
                        gapless
                        and seq is not None
                        and seq > tenant.last_seq + 1
                    ):
                        # pipelined out-of-order arrival (docstring):
                        # refuse rather than ratchet the watermark over
                        # the hole; no capacity consumed, no shed counted
                        # against the tenant — the earlier seq's failure
                        # already was
                        raise BackpressureError(
                            "seq_gap",
                            f"tenant {tenant.id!r}: seq {seq} arrived with "
                            f"seq {tenant.last_seq + 1} still unadmitted; "
                            "redeliver in order (an earlier pipelined "
                            "frame shed or failed).",
                            tenant=tenant.id,
                        )
                    if self._draining:
                        raise ServeError(
                            "draining",
                            f"tenant {tenant.id!r}: this daemon is draining; "
                            "resubmit after the router migrates the tenant.",
                        )
                    if len(tenant.queue) < tenant.capacity:
                        break
                    if not block:
                        self._shed(tenant, "queue_full")
                    remaining = (
                        None
                        if deadline is None
                        else deadline - time.monotonic()
                    )
                    if remaining is not None and remaining <= 0:
                        self._shed(tenant, "queue_full")
                    if not self._cond.wait(timeout=remaining):
                        self._shed(tenant, "queue_full")
                tenant.ingested += 1
                step = tenant.ingested
                if seq is not None:
                    tenant.last_seq = seq
                if not _chaos.ingest_armed():
                    tenant.queue.append(
                        ("batch", (seq, args, stage, None), None)
                    )
                    stage = None  # the queue entry owns it now
                    tenant.last_activity = time.monotonic()
                    depth = len(tenant.queue)
                    self._cond.notify_all()
                    args = None
            if args is not None:
                # chaos slow path (test-only): the fault fires at the queue
                # boundary for a batch that PASSED admission — only admitted
                # batches advance ``step``, so a shed can never consume the
                # one-shot fault — and OUTSIDE the lock, so an ingestion
                # delay stalls only this producer. The re-acquire below may
                # transiently exceed the queue bound by the number of
                # concurrent producers mid-hook; chaos is disarmed in
                # production, where the bound is exact.
                args = _chaos.on_ingest(tenant.id, step, args)
                with self._cond:
                    self._check_live(tenant)
                    tenant.queue.append(
                        ("batch", (seq, args, stage, None), None)
                    )
                    stage = None
                    tenant.last_activity = time.monotonic()
                    depth = len(tenant.queue)
                    self._cond.notify_all()
        finally:
            if stage is not None:
                stage.release()
        elapsed = time.perf_counter() - t0
        self._ewma("submit", elapsed)
        if _obs._enabled:
            _obs.counter("serve.ingest.batches", tenant=tenant.id)
            _obs.histo("serve.queue_depth", float(depth), tenant=tenant.id)
            # admission-to-enqueue latency: the SLO drill's instrument (a
            # chaos ingest_delay stalls exactly this path) and the
            # load_report's submit_p99_s source
            _obs.histo("serve.submit.latency", elapsed, tenant=tenant.id)
        return True

    _EWMA_ALPHA = 0.2

    def _ewma(self, key: str, seconds: float) -> None:
        prev = self._lat_ewma.get(key)
        self._lat_ewma[key] = (
            seconds
            if prev is None
            else prev + self._EWMA_ALPHA * (seconds - prev)
        )

    def _shed(self, tenant: _Tenant, reason: str) -> None:
        tenant.sheds += 1
        if _obs._enabled:
            _obs.counter("serve.ingest.sheds", tenant=tenant.id, reason=reason)
        raise BackpressureError(
            reason,
            f"tenant {tenant.id!r} queue is full "
            f"({tenant.capacity} batches pending); batch shed — back off, "
            "block=True, or raise queue_capacity.",
            tenant=tenant.id,
        )

    def _check_live(self, tenant: _Tenant) -> None:
        """Raise the tenant's terminal error (or a daemon error) if this
        tenant can no longer accept work. Caller holds the lock."""
        if not self._running:
            raise ServeError(
                "daemon_stopped", "the daemon has been stopped."
            )
        if tenant.status is not TenantStatus.ACTIVE:
            if tenant.error is not None:
                raise tenant.error
            raise ServeError(
                "tenant_detached",
                f"tenant {tenant.id!r} is {tenant.status.value}.",
            )

    def _request(
        self,
        tenant: _Tenant,
        kind: str,
        *,
        timeout: Optional[float],
        payload: Any = None,
    ) -> Any:
        promise = _Promise()
        with self._cond:
            self._check_live(tenant)
            tenant.queue.append((kind, payload, promise))
            tenant.last_activity = time.monotonic()
            self._cond.notify_all()
        return promise.result(timeout)

    def _detach(
        self,
        tenant: _Tenant,
        *,
        checkpoint: bool,
        timeout: Optional[float],
    ) -> Optional[str]:
        with self._cond:
            if tenant.status is not TenantStatus.ACTIVE or not self._running:
                # terminal tenants (and stopped daemons) detach directly:
                # there is no worker round trip to make, only a slot to
                # clear — the checkpoint, if the tenant was evicted, already
                # exists and its path is on the error
                self._tenants.pop(tenant.id, None)
                prev = tenant.status
                if tenant.status is TenantStatus.ACTIVE:
                    tenant.status = TenantStatus.DETACHED
                if _obs._enabled:
                    _obs.gauge(
                        "serve.tenants.active", float(len(self._tenants))
                    )
                return (
                    tenant.error.checkpoint
                    if (
                        prev is TenantStatus.EVICTED
                        and isinstance(tenant.error, TenantEvictedError)
                    )
                    else None
                )
        return self._request(
            tenant,
            "detach",
            timeout=timeout,
            payload={"checkpoint": checkpoint, "evict": False},
        )

    def evict(
        self, tenant_id: str, *, timeout: Optional[float] = None
    ) -> str:
        """Explicitly evict an active tenant: drain its queue, fold and
        checkpoint its state, free its slot. Returns the checkpoint path;
        the handle's next op raises :class:`TenantEvictedError` carrying
        the same path. (The watchdog calls the same machinery for tenants
        idle past ``watchdog_timeout_s``.)"""
        with self._cond:
            tenant = self._tenants.get(tenant_id)
            if tenant is None or tenant.status is not TenantStatus.ACTIVE:
                raise ServeError(
                    "unknown_tenant",
                    f"no active tenant {tenant_id!r} to evict.",
                )
        return self._request(
            tenant,
            "detach",
            timeout=timeout,
            payload={"checkpoint": True, "evict": True},
        )

    def drain(
        self, *, timeout: Optional[float] = None
    ) -> Dict[str, Optional[str]]:
        """Gracefully hand every tenant off this host: stop
        admitting work (new ``attach``/``submit`` reject with a structured
        ``"draining"`` reason), then evict each ACTIVE tenant — drain its
        queue, fold + checkpoint atomically, free the slot — and return
        ``{tenant_id: checkpoint_path}``. A cluster router calls this
        before taking a host down, then re-attaches the tenants elsewhere
        from the returned checkpoints; quarantined tenants have no
        trustworthy state to hand off and are omitted. The daemon stays
        up (``health()`` keeps answering) so the router can verify the
        drain; ``stop()`` it afterwards. ``timeout`` bounds each tenant's
        eviction round trip."""
        from torcheval_tpu_torch.metrics.toolkit import _check_timeout_s

        _check_timeout_s(timeout)
        with self._cond:
            if not self._running:
                raise ServeError(
                    "daemon_stopped", "cannot drain a stopped daemon."
                )
            self._draining = True
            victims = [
                t.id
                for t in self._tenants.values()
                if t.status is TenantStatus.ACTIVE
            ]
        out: Dict[str, Optional[str]] = {}
        for tid in victims:
            try:
                out[tid] = self.evict(tid, timeout=timeout)
            except ServeError:
                # quarantined mid-drain, or detached by a racing client:
                # either way there is no state to hand off
                continue
        if _obs._enabled:
            _obs.counter("serve.drains")
            _trace.instant(
                "serve.drained", kind="serve", tenants=len(out)
            )
        # subscribers see the drain's own counters/trace in a final push
        # rather than learning about it from a dead socket
        self._notify_flush_hooks()
        return out

    # ---------------------------------------------------------- worker side
    def _worker_loop(self) -> None:
        if self._device.type == "cuda":
            # entered once: every kernel of every tenant runs on this
            # thread's current stream of the daemon's device
            with torch.cuda.device(self._device):
                self._worker_passes()
        else:
            self._worker_passes()

    def _worker_passes(self) -> None:
        while True:
            with self._cond:
                if not self._running:
                    self._fail_pending_locked()
                    return
                if not self._has_work_locked():
                    self._cond.wait(timeout=self._watchdog_interval_s)
                if not self._running:
                    self._fail_pending_locked()
                    return
                plans = self._plan_pass_locked()
            self._stage_pass(plans)
            for tenant, items in plans:
                self._serve_tenant(tenant, items)
            self._check_watchdogs()

    def _has_work_locked(self) -> bool:
        return any(
            t.queue and t.status is TenantStatus.ACTIVE
            for t in self._tenants.values()
        )

    def _plan_pass_locked(self):
        """Pop every active tenant's queued items and order the pass:
        control-first (the per-tenant fallback lane — a compute/detach is
        served immediately, never parked behind a signature group), then
        batch tenants grouped by head-batch signature so same-signature
        tenants run back-to-back. Popping frees queue capacity, so blocked submitters wake."""
        plans = []
        for t in self._tenants.values():
            if t.queue and t.status is TenantStatus.ACTIVE:
                items = list(t.queue)
                t.queue.clear()
                plans.append((t, items))
                if _obs._enabled:
                    # dequeue-side occupancy sample: the pop empties the
                    # queue while we hold the lock, so an idle-draining
                    # tenant's depth series actually falls to 0 instead of
                    # freezing at the last submit's reading
                    _obs.histo("serve.queue_depth", 0.0, tenant=t.id)
        if not plans:
            return plans
        self._cond.notify_all()
        control, groups = [], {}
        for entry in plans:
            head = entry[1][0]
            if head[0] != "batch":
                control.append(entry)
            else:
                # batch payload is (seq, args); group on the args signature
                groups.setdefault(
                    _batch_signature(head[1][1]), []
                ).append(entry)
        return control + [e for sig in groups for e in groups[sig]]

    def _stage_pass(self, plans) -> None:
        """Coalesced H2D for one serving pass: every queued host (numpy)
        batch in ``plans`` moves to the device in ONE copy per (device,
        signature) group — not one per batch per tenant — and its queue
        entry is rewritten in place with the placed tensors plus an
        ``owned`` verdict (exclusively-owned tensors may be released by
        the window before its fold math; views shared via identical host
        arrays may not). On CUDA the copy runs on the daemon's copy
        stream from a pinned slot, and pooled staging buffers release on
        the copy's event.

        Excluded and left on the per-batch path: tenants under
        ``nan_policy="reject"`` (their priced host-side NaN scan must see
        host memory), sliced tenants (``_host_ingest_only``), non-numpy
        args (tensors, scalars), and collections without one plain
        ``torch.device``."""
        groups: Dict[tuple, list] = {}
        for tenant, items in plans:
            if tenant.nan_policy == "reject":
                continue
            if getattr(tenant.collection, "_host_ingest_only", False):
                # sliced tenants: the slice-id column must stay host-side
                # until the collection interns it — a coalesced H2D here
                # would strand the ids on device and force a readback per
                # batch
                continue
            device = _collection_device(tenant.collection)
            if device is None:
                continue
            for i, (kind, payload, _promise) in enumerate(items):
                if kind != "batch":
                    continue
                args = payload[1]
                if not args or not all(
                    type(a) is np.ndarray and a.dtype.kind in "biufc"
                    for a in args
                ):
                    continue
                sig = tuple((a.shape, a.dtype) for a in args)
                groups.setdefault((device, sig), []).append((device, items, i))
        for members in groups.values():
            device = members[0][0]
            batches = [items[i][1][1] for _dev, items, i in members]
            try:
                placed, owned, anchor = self._coalesce(batches, device)
            except Exception:  # noqa: BLE001 - fall back to per-batch path
                # an unplaceable group (device trouble) keeps the host
                # arrays; the per-batch update path will surface the real
                # error inside the owning tenant's containment wall
                continue
            for (_dev, items, i), dev_args, own in zip(members, placed, owned):
                kind, payload, promise = items[i]
                stage = payload[2] if len(payload) > 2 else None
                items[i] = (kind, (payload[0], dev_args, None, own), promise)
                if stage is not None:
                    # host bytes are consumed once the group's copy has
                    # run: the copy's event (None on the CPU, where the
                    # copy finished before coalesce_h2d returned)
                    stage.release(anchor=anchor)

    def _coalesce(self, batches, device: torch.device):
        """``ingest.coalesce_h2d`` through the daemon's staging pool and
        copy stream (``device`` is the daemon's: attach refuses others)."""
        from torcheval_tpu_torch.serve import ingest as _ingest

        return _ingest.coalesce_h2d(
            batches, device, pool=self._stage_pool, stream=self._copy_stream
        )

    def _serve_tenant(self, tenant: _Tenant, items) -> None:
        t0 = time.perf_counter()
        try:
            self._serve_tenant_inner(tenant, items)
        finally:
            self._ewma("step", time.perf_counter() - t0)

    def _serve_tenant_inner(self, tenant: _Tenant, items) -> None:
        with _obs.span("serve.tenant.step", tenant=tenant.id):
            for idx, (kind, payload, promise) in enumerate(items):
                try:
                    if kind == "batch":
                        self._process_batch(tenant, payload)
                    elif kind == "compute":
                        promise.resolve(
                            self._guarded(tenant, tenant.collection.compute)
                        )
                    elif kind == "sync_compute":
                        self._do_sync_compute(tenant, payload, promise)
                    elif kind == "flush":
                        self._do_flush(tenant, promise)
                    elif kind == "detach":
                        self._do_detach(tenant, payload, promise)
                except Exception as exc:  # noqa: BLE001 - containment wall
                    err = self._classify_and_quarantine(tenant, kind, exc)
                    # the rest of this tenant's popped items die with it:
                    # batches drop (their staging buffers release — no
                    # pool leak across a quarantine), promises learn the
                    # structured reason
                    for _k, _p, pr in items[idx:]:
                        self._release_stage(_k, _p)
                        if pr is not None and not pr.event.is_set():
                            pr.reject(err)
                    return
        with self._cond:
            tenant.last_activity = time.monotonic()

    def _release_stage(self, kind: str, payload: Any) -> None:
        """Free a dropped queue entry's pooled staging buffer (idempotent;
        entries the staging pass already placed carry ``stage=None``)."""
        if kind == "batch" and len(payload) > 2 and payload[2] is not None:
            payload[2].release(anchor=_ingest_anchor(self._device))

    def _process_batch(self, tenant: _Tenant, payload: tuple) -> None:
        # (seq, args) legacy 2-tuples still appear in tests that inject
        # queue entries directly; the full form is (seq, args, stage,
        # owned) — ``owned`` non-None means the staging pass already
        # placed ``args`` on device (and vouches for buffer ownership)
        seq, args = payload[0], payload[1]
        stage = payload[2] if len(payload) > 2 else None
        owned = payload[3] if len(payload) > 3 else None
        release_anchor = None
        try:
            if tenant.nan_policy == "reject":
                self._nan_check(tenant, args)
            if owned is None and stage is not None:
                # stage-backed host views that skipped the staging pass
                # (nan-reject tenants, fallback): place them HERE so the
                # stage's release anchors on exactly the copy that read
                # the pooled bytes — an unrelated anchor (or none) could
                # recycle the slot mid-read
                placed = self._place_batch(tenant, args)
                if placed is not None:
                    args, release_anchor, owned = placed
                else:
                    # no plain device to anchor a transfer on (sharded
                    # placements, exotic args): materialize the views
                    # once so the slot can free with zero aliasing risk
                    args = tuple(
                        np.array(a) if isinstance(a, np.ndarray) else a
                        for a in args
                    )
            if owned is None:
                self._guarded(
                    tenant, lambda: tenant.collection.update(*args)
                )
            else:
                self._guarded(
                    tenant,
                    lambda: tenant.collection.update_placed(
                        args, owned=owned
                    ),
                )
        finally:
            if stage is not None:
                # release_anchor covers the staged-placement case; every
                # other path above either materialized the views (no
                # aliasing left) or never read the stage (early raise)
                stage.release(anchor=release_anchor)
        tenant.processed += 1
        if seq is not None:
            # worker-thread-only write: the applied watermark is what a
            # checkpoint taken on this thread can truthfully claim. The
            # per-tenant queue is FIFO so seqs arrive ascending; max() is
            # armor against any future scheduler reordering quietly
            # regressing the watermark below an applied seq
            tenant.applied_seq = max(tenant.applied_seq, seq)

    def _place_batch(self, tenant: _Tenant, args: tuple):
        """Device-place one stage-backed host batch through the ingest
        transfer machinery; returns ``(placed_args, anchor, owned)`` or
        ``None`` when the batch is not eligible (mirrors the staging
        pass's gates)."""
        device = _collection_device(tenant.collection)
        if (
            device is None
            or getattr(tenant.collection, "_host_ingest_only", False)
            or not args
            or not all(
                type(a) is np.ndarray and a.dtype.kind in "biufc"
                for a in args
            )
        ):
            return None
        try:
            placed, owned, anchor = self._coalesce([args], device)
        except Exception:  # noqa: BLE001 - keep the host-path fallback
            return None
        # owned[0] is False only when one host array appeared twice in
        # the batch (its device view is shared)
        return placed[0], anchor, owned[0]

    @staticmethod
    def _nan_check(tenant: _Tenant, args: tuple) -> None:
        for a in args:
            if isinstance(a, torch.Tensor):
                if a.is_floating_point() and bool(torch.isnan(a).any()):
                    raise _NaNPolicyViolation(
                        f"tenant {tenant.id!r} submitted a float batch "
                        "containing NaN under nan_policy='reject'."
                    )
                continue
            try:
                arr = np.asarray(a)
            except Exception:
                continue
            if arr.dtype.kind == "f" and bool(np.isnan(arr).any()):
                raise _NaNPolicyViolation(
                    f"tenant {tenant.id!r} submitted a float batch "
                    "containing NaN under nan_policy='reject'."
                )

    def _guarded(self, tenant: _Tenant, fn):
        """Run one tenant device step under its toolkit watchdog deadline
        (``toolkit._sync_deadline`` + ``_run_guarded`` — the exact
        machinery the sync APIs use). ``None`` = unguarded (the default;
        guarding costs one thread per step)."""
        if tenant.step_timeout_s is None:
            return fn()
        from torcheval_tpu_torch.metrics import toolkit as tk

        if self._device.type == "cuda":
            # the watchdog runs the step on a thread of its own: it enters
            # the daemon's device, so its kernels go to the same stream
            inner = fn

            def fn():
                with torch.cuda.device(self._device):
                    return inner()

        with tk._sync_deadline(tenant.step_timeout_s):
            return tk._run_guarded(fn, "serve.step", "serve")

    def _do_sync_compute(
        self, tenant: _Tenant, payload: dict, promise: _Promise
    ) -> None:
        """Cross-rank sync of one tenant's metrics on the worker thread.
        A SyncError here is the CLIENT's to handle (it chose timeout_s /
        on_failure) and the tenant's local state is untouched by a failed
        exchange — so sync failures reject the promise without
        quarantining."""
        from torcheval_tpu_torch.metrics import toolkit as tk

        try:
            promise.resolve(
                tk.sync_and_compute_collection(
                    dict(tenant.collection.metrics),
                    recipient_rank="all",
                    timeout_s=payload["timeout_s"],
                    on_failure=payload["on_failure"],
                )
            )
        except tk.SyncError as exc:
            promise.reject(exc)

    def _do_detach(
        self, tenant: _Tenant, payload: dict, promise: _Promise
    ) -> None:
        """Graceful detach / explicit eviction, on the worker: optionally
        fold+checkpoint, then free the slot. A checkpoint failure (disk
        full, schema surprise) rejects the promise and leaves the tenant
        ACTIVE — environmental errors are not tenant poison."""
        path = None
        try:
            if payload["checkpoint"]:
                path = self._checkpoint_tenant(tenant)
                tenant.durable_seq = tenant.applied_seq
        except Exception as exc:  # noqa: BLE001 - relayed to the caller
            promise.reject(exc)
            return
        evict = payload["evict"]
        with self._cond:
            if evict:
                tenant.status = TenantStatus.EVICTED
                tenant.error = TenantEvictedError(
                    "evicted",
                    f"tenant {tenant.id!r} was evicted; resume from "
                    f"{path!r}.",
                    tenant=tenant.id,
                    checkpoint=path,
                )
                self._totals["evicted"] += 1
            else:
                tenant.status = TenantStatus.DETACHED
            self._tenants.pop(tenant.id, None)
            if _obs._enabled:
                _obs.gauge("serve.tenants.active", float(len(self._tenants)))
        if evict and _obs._enabled:
            _obs.counter(
                "serve.evictions", tenant=tenant.id, reason="explicit"
            )
        promise.resolve(path)

    def _do_flush(self, tenant: _Tenant, promise: _Promise) -> None:
        """Checkpoint the tenant's current folded state WITHOUT evicting
        it — the wire client's replay-buffer valve: a flush advances the
        durable watermark so the client can prune acked-and-now-durable
        batches from its bounded replay buffer. An environmental
        checkpoint failure rejects the promise and leaves the tenant
        ACTIVE (same contract as detach — disk trouble is not tenant
        poison)."""
        try:
            path = self._checkpoint_tenant(tenant)
        except Exception as exc:  # noqa: BLE001 - relayed to the caller
            promise.reject(exc)
            return
        tenant.durable_seq = tenant.applied_seq
        promise.resolve({"path": path, "acked_seq": tenant.durable_seq})

    def _checkpoint_tenant(self, tenant: _Tenant, *, rotate: bool = True) -> str:
        from torcheval_tpu_torch.resilience.snapshot import save

        ckpt_dir = self._tenant_ckpt_dir(tenant.id, create=True)
        # worker thread: every queued batch ahead of this request has been
        # applied, so applied_seq is exactly the set of batches the folded
        # state (and therefore this checkpoint) contains. The watermark
        # rides the manifest's ``extra`` through the same atomic publish.
        # NOTE: callers commit ``tenant.durable_seq`` themselves AFTER the
        # checkpoint is known to stick — the idle-eviction path can still
        # DISCARD this checkpoint if a submit raced in, and a watermark
        # advanced for a discarded checkpoint would let a client prune
        # replay entries whose only durable copy was just deleted.
        # ``rotate=False`` defers keep_last rotation for the same reason:
        # rotating at save time and then discarding the new checkpoint
        # could leave ZERO checkpoints behind (with keep_last=1 the save
        # deletes the old durable one and the abort deletes the new one)
        # — the idle path rotates only after its eviction commits.
        with _obs.span("serve.tenant.evict", tenant=tenant.id):
            return save(
                tenant.collection,
                ckpt_dir,
                keep_last=self._evict_keep_last if rotate else None,
                extra={"serve": {"acked_seq": tenant.applied_seq}},
            )

    def _rotate_tenant_ckpts(self, tenant_id: str) -> None:
        """Apply ``evict_keep_last`` rotation after a deferred-rotation
        checkpoint COMMITTED (see ``_checkpoint_tenant(rotate=False)``)."""
        from torcheval_tpu_torch.resilience.snapshot import rotate_checkpoints

        ckpt_dir = self._tenant_ckpt_dir(tenant_id, create=False)
        if ckpt_dir is None or self._evict_keep_last is None:
            return
        rotate_checkpoints(ckpt_dir, self._evict_keep_last)

    def _classify_and_quarantine(
        self, tenant: _Tenant, kind: str, exc: Exception
    ) -> TenantQuarantinedError:
        from torcheval_tpu_torch.metrics import toolkit as tk

        if isinstance(exc, _NaNPolicyViolation):
            reason = "nan_policy"
        elif isinstance(exc, tk.SyncTimeoutError):
            reason = "step_timeout"
        elif kind == "batch":
            reason = "poisoned_batch"
        else:
            reason = "compute_error"
        err = TenantQuarantinedError(
            reason,
            f"tenant {tenant.id!r} quarantined: {exc!r}. Other tenants are "
            "unaffected; detach and re-attach to start clean.",
            tenant=tenant.id,
        )
        err.__cause__ = exc
        with self._cond:
            tenant.status = TenantStatus.QUARANTINED
            tenant.error = err
            # anything still queued dies with the tenant: batches drop
            # (and release their staging buffers — a quarantine must not
            # leak pool slots), waiting promises learn the reason
            for _k, _p, pr in tenant.queue:
                self._release_stage(_k, _p)
                if pr is not None and not pr.event.is_set():
                    pr.reject(err)
            tenant.queue.clear()
            self._totals["quarantined"] += 1
            self._cond.notify_all()
        _logger.warning(
            "serve: quarantined tenant %r (%s): %r", tenant.id, reason, exc
        )
        if _obs._enabled:
            _obs.counter("serve.quarantines", tenant=tenant.id, reason=reason)
            _trace.instant(
                "serve.tenant.quarantined",
                kind="serve",
                tenant=tenant.id,
                reason=reason,
            )
        return err

    def _check_watchdogs(self) -> None:
        now = time.monotonic()
        victims = []
        with self._cond:
            for t in self._tenants.values():
                if (
                    t.status is TenantStatus.ACTIVE
                    and t.watchdog_timeout_s is not None
                    and not t.queue
                    and now - t.last_activity >= t.watchdog_timeout_s
                ):
                    victims.append(t)
        for t in victims:
            self._evict_idle(t)

    def _evict_idle(self, tenant: _Tenant) -> None:
        """Watchdog eviction of an idle (stuck-producer) tenant: fold +
        checkpoint, then free the slot. The save runs on the worker thread
        OUTSIDE the daemon lock (holding it across a fold + fsync would
        stall every tenant's submit for the save's duration); it is safe
        unlocked because only this thread ever touches the collection. The
        eviction then commits under the lock ONLY if the tenant is still
        idle — a submit that raced in during the save means the tenant is
        live (and the checkpoint stale), so the eviction aborts and the
        just-published checkpoint is discarded (a mid-stream snapshot left
        behind would become a wrong resume source for a later
        ``resume="auto"`` attach)."""
        with self._cond:
            if (
                tenant.status is not TenantStatus.ACTIVE
                or tenant.queue
                or self._tenants.get(tenant.id) is not tenant
            ):
                return  # a submit raced the watchdog: the tenant is live
        try:
            # rotation deferred to the commit below: if the eviction
            # aborts, the discarded checkpoint must not have rotated away
            # the previous durable one (clients pruned replay buffers
            # against its watermark)
            path = self._checkpoint_tenant(tenant, rotate=False)
        except Exception as exc:  # noqa: BLE001 - never kill the worker
            _logger.warning(
                "serve: idle eviction of %r failed to checkpoint (%r); "
                "leaving the tenant attached.",
                tenant.id,
                exc,
            )
            return
        with self._cond:
            if (
                tenant.status is not TenantStatus.ACTIVE
                or tenant.queue
                or self._tenants.get(tenant.id) is not tenant
            ):
                # activity landed during the save: abort and discard the
                # now-stale checkpoint (only this thread consumes queues,
                # so ANY new work is visible here as a non-empty queue;
                # durable_seq was never advanced for it, so no client has
                # pruned replay entries against the discarded copy)
                shutil.rmtree(path, ignore_errors=True)
                return
            tenant.durable_seq = tenant.applied_seq
            tenant.status = TenantStatus.EVICTED
            tenant.error = TenantEvictedError(
                "watchdog_idle",
                f"tenant {tenant.id!r} idle past its watchdog deadline "
                f"({tenant.watchdog_timeout_s}s) was evicted; resume from "
                f"{path!r}.",
                tenant=tenant.id,
                checkpoint=path,
            )
            self._tenants.pop(tenant.id, None)
            self._totals["evicted"] += 1
            if _obs._enabled:
                _obs.gauge("serve.tenants.active", float(len(self._tenants)))
        self._rotate_tenant_ckpts(tenant.id)
        _logger.warning(
            "serve: evicted idle tenant %r (checkpoint %s)", tenant.id, path
        )
        if _obs._enabled:
            _obs.counter(
                "serve.evictions", tenant=tenant.id, reason="watchdog_idle"
            )
            _trace.instant(
                "serve.tenant.evicted",
                kind="serve",
                tenant=tenant.id,
                reason="watchdog_idle",
            )

    def _fail_pending_locked(self) -> None:
        err = ServeError("daemon_stopped", "the daemon has been stopped.")
        for t in self._tenants.values():
            for _k, _p, pr in t.queue:
                self._release_stage(_k, _p)
                if pr is not None and not pr.event.is_set():
                    pr.reject(err)
            t.queue.clear()

    # --------------------------------------------------------------- health
    _LOAD_REPORT_SCHEMA = 1

    def load_report(self) -> Dict[str, Any]:
        """Structured, schema-versioned load telemetry for this host —
        the unit the obs push channel labels into every delta, ``health()``
        embeds, the ``/health`` scrape endpoint serves, and
        ``EvalRouter.fleet_status()`` folds per host (the signal layer
        ROADMAP item 1's placement loop consumes).

        Top-level keys are STABLE under ``schema == 1`` (pinned by
        ``tests/serve/test_load_report.py``); additions bump the schema::

            {"schema": 1, "ts": ..., "uptime_s": ..., "running": ...,
             "draining": ..., "capacity": {...}, "queue": {...},
             "latency": {...}, "window": {...}, "ingest": {...},
             "hbm": {...}, "totals": {...}}

        Latency p99s fold the registry's ``serve.submit.latency``
        histograms / ``serve.tenant.step`` span buckets across tenants
        (bucket summation — exact); EWMAs are the daemon's own running
        aggregates; HBM folds the ``obs.cost.hbm_bytes{entry=}`` gauges.
        When obs is disabled the registry-derived fields read 0 — the
        queue/capacity/totals fields are daemon-native and always live."""
        now = time.monotonic()
        with self._cond:
            per_tenant = {
                t.id: len(t.queue) for t in self._tenants.values()
            }
            backlog = 0
            for t in self._tenants.values():
                for kind, payload, _p in t.queue:
                    if kind == "batch":
                        for a in payload[1] or ():
                            backlog += int(getattr(a, "nbytes", 0) or 0)
            out: Dict[str, Any] = {
                "schema": self._LOAD_REPORT_SCHEMA,
                "ts": time.time(),
                "uptime_s": (
                    now - self._started_at if self._started_at else 0.0
                ),
                "running": self._running,
                "draining": self._draining,
                "capacity": {
                    "max_tenants": self._max_tenants,
                    "active_tenants": len(self._tenants),
                },
                "queue": {
                    "depth": sum(per_tenant.values()),
                    "capacity": sum(
                        t.capacity for t in self._tenants.values()
                    ),
                    "per_tenant": per_tenant,
                },
                "ingest": {"backlog_bytes": backlog},
                "totals": dict(self._totals),
            }
            ewma = dict(self._lat_ewma)
        # registry folds OUTSIDE the daemon lock (the registry has its own)
        from torcheval_tpu_torch.obs.registry import (
            HISTOGRAM_BUCKETS,
            default_registry,
            percentile_from_buckets,
        )

        submit_b = [0] * HISTOGRAM_BUCKETS
        submit_c = 0
        step_b = [0] * HISTOGRAM_BUCKETS
        step_c = 0
        occ_sum, occ_c = 0.0, 0
        hbm_max, hbm_sum = 0.0, 0.0
        for kind, name, _lb, value in default_registry._items():
            if kind == "histo" and name == "serve.submit.latency":
                for i, c in enumerate(value[0]):
                    submit_b[i] += c
                submit_c += value[1]
            elif kind == "span" and name == "serve.tenant.step":
                for i, c in enumerate(value[3]):
                    step_b[i] += c
                step_c += value[0]
            elif kind == "histo" and name == "deferred.window_occupancy":
                occ_sum += value[2]
                occ_c += value[1]
            elif kind == "gauge" and name == "obs.cost.hbm_bytes":
                hbm_max = max(hbm_max, value)
                hbm_sum += value
        out["latency"] = {
            "submit_ewma_s": ewma.get("submit", 0.0),
            "step_ewma_s": ewma.get("step", 0.0),
            "submit_p99_s": percentile_from_buckets(
                submit_b, submit_c, 0.99
            ),
            "step_p99_s": percentile_from_buckets(step_b, step_c, 0.99),
        }
        out["window"] = {
            "occupancy_mean": occ_sum / occ_c if occ_c else 0.0,
            "samples": occ_c,
        }
        out["hbm"] = {
            "bytes_max_entry": hbm_max,
            "bytes_sum": hbm_sum,
        }
        return out

    def list_tenants(self) -> Dict[str, Dict[str, Any]]:
        """The tenant directory a recovering control plane reconciles
        against: every attached tenant's status and seq
        watermarks, one cheap read under the daemon lock. ``last_seq`` is
        the highest wire sequence this daemon has admitted (a restarted
        router resumes its client-side numbering from here);
        ``durable_seq`` is the checkpointed watermark. Served over the
        wire as the ``list_tenants`` op."""
        with self._cond:
            return {
                t.id: {
                    "status": t.status.value,
                    "last_seq": t.last_seq,
                    "durable_seq": t.durable_seq,
                }
                for t in self._tenants.values()
            }

    def health(
        self,
        *,
        sync: bool = False,
        timeout_s: Optional[float] = None,
        on_failure: str = "raise",
    ) -> Dict[str, Any]:
        """Structured daemon health snapshot: per-tenant status, queue
        depth, ingest/shed totals and idle age, plus daemon capacity and
        lifetime counts. With ``sync=True`` the snapshot also carries
        ``"cluster"`` — every rank's obs registry/timeline merged over
        ``obs.sync_snapshot()``'s single collective round, under the toolkit
        ``timeout_s``/``on_failure`` contract (a monitoring loop keeps
        reporting through a preemption with ``on_failure="local"``)."""
        now = time.monotonic()
        with self._cond:
            tenants = {
                t.id: {
                    "status": t.status.value,
                    "queue_depth": len(t.queue),
                    "queue_capacity": t.capacity,
                    "ingested": t.ingested,
                    "processed": t.processed,
                    "sheds": t.sheds,
                    "dupes": t.dupes,
                    "last_seq": t.last_seq,
                    "applied_seq": t.applied_seq,
                    "durable_seq": t.durable_seq,
                    "idle_s": now - t.last_activity,
                }
                for t in self._tenants.values()
            }
            out: Dict[str, Any] = {
                "running": self._running,
                "draining": self._draining,
                "worker_alive": (
                    self._thread.is_alive() if self._thread else False
                ),
                "uptime_s": (
                    now - self._started_at if self._started_at else 0.0
                ),
                "capacity": {
                    "max_tenants": self._max_tenants,
                    "active_tenants": len(self._tenants),
                },
                "totals": dict(self._totals),
                "tenants": tenants,
            }
        # outside the lock: load_report() re-acquires it (and the old-peer
        # fallback path reads this — a subscriber polling health() still
        # sees the same structured load telemetry a push would carry)
        out["load_report"] = self.load_report()
        if sync:
            from torcheval_tpu_torch import obs

            out["cluster"] = obs.sync_snapshot(
                timeout_s=timeout_s, on_failure=on_failure
            )
        return out

    def __repr__(self) -> str:
        with self._lock:
            n = len(self._tenants)
        state = "running" if self._running else "stopped"
        return f"EvalDaemon({state}, tenants={n}/{self._max_tenants})"
