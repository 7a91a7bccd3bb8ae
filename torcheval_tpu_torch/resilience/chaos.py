"""Env-gated fault injection for the sync path and the serve queue (test-only).

JAX counterpart: ``torcheval_tpu/resilience/chaos.py``, with every action
family and the same ``TORCHEVAL_TPU_CHAOS*`` environment names and defaults,
so that one drill's environment arms both packages. The rank a fault
targets is the ``torch.distributed`` rank (0 without a process group).
A preemption looks, from the surviving processes' point of view, like one
rank silently vanishing (or stalling) between two collective rounds: the
healthy ranks then block inside the next collective. A misbehaving eval
*client* looks different: a corrupted batch (wrong shape, NaN payload)
entering a serving queue. Both fault families inject here, armed through
the environment before launch. The ingest, host, ack and router hooks have
no caller in the port yet (it has no serving layer); the sync hook is
called by ``metrics/toolkit.py::_allgather_stacked`` and the checkpoint
hook by ``resilience/snapshot.py::save``.

``TORCHEVAL_TPU_CHAOS``
    ``"1"`` arms the hooks; anything else (or unset) leaves them disabled.
    Disabled cost is one cached-config check per hook call — host code on
    paths that are about to block on the network or a queue, so it is free.
``TORCHEVAL_TPU_CHAOS_ACTION``
    Which fault. **Sync-funnel actions** (fire in ``on_sync_round``, at the
    ``toolkit._allgather_stacked`` choke point):

    * ``"kill"`` (default) — ``os._exit(TORCHEVAL_TPU_CHAOS_EXIT_CODE)``,
      modelling a hard preemption: no Python cleanup, no atexit, no goodbye
      to the coordinator.
    * ``"delay"`` — sleep ``TORCHEVAL_TPU_CHAOS_DELAY_S`` seconds before
      entering the round, modelling a straggler.

    **Ingestion actions** (fire in ``on_ingest``, at the serve queue
    boundary — the exact point a real client's bad batch would enter):

    * ``"poison"`` — corrupt the chosen batch's payload before it is
      queued: ``TORCHEVAL_TPU_CHAOS_POISON="nan"`` (default) replaces the
      first float array with all-NaN; ``"shape"`` drops the first array's
      last row, so the batch arrives with mismatched leading dims.
    * ``"ingest_delay"`` — sleep ``TORCHEVAL_TPU_CHAOS_DELAY_S`` before
      queuing the chosen batch, modelling a stalled producer (the fault
      the serve watchdog's idle eviction exists for).
    * ``"load_spike"`` (alias ``"hot_tenant"``) — the elastic-fleet
      load generator: from the chosen step ON, EVERY admitted batch
      of the chosen tenant pays ``TORCHEVAL_TPU_CHAOS_DELAY_S`` of
      synthetic service time before queuing. Unlike every other
      ingestion action this fires REPEATEDLY, never consumes the
      one-shot budget, and never corrupts the payload — metric results
      stay bit-identical to a fault-free oracle while the host's
      ``serve.submit.latency`` histogram and submit EWMA (and therefore
      its ``load_report`` and the router's placement weight) read
      deterministically hot, which is exactly what the rebalance and
      hot-tenant-split paths need to trigger in tests and drills. Set
      ``TORCHEVAL_TPU_CHAOS_DELAY_S`` explicitly — the 30 s default
      models a straggler, not a cadence multiplier.

    **Host actions** (fire in ``on_host_request``, at the eval wire
    server's request dispatch — the surfaces a whole-host loss presents
    to remote clients):

    * ``"host_kill"`` — ``os._exit`` BEFORE processing the chosen
      request: the host vanishes mid-window, the un-acked batch was
      never applied, clients see dead connections from then on.
    * ``"host_partition"`` — from the chosen request on, the server
      reads requests and never answers (nor processes them): TCP is up,
      the service is gone — clients must discover it by deadline, not by
      connection error.
    * ``"ack_drop"`` — process the chosen request fully, then
      ``os._exit`` BEFORE the ack leaves: the exactly-once hard case —
      the client cannot know whether its batch landed, must resend, and
      only server-side sequence dedup (or the batch dying with the
      host's un-checkpointed state) keeps the metric exactly-once.

    Host actions select their request with ``TORCHEVAL_TPU_CHAOS_TENANT``
    and ``TORCHEVAL_TPU_CHAOS_STEP`` (the 1-based index among *submit*
    requests for the matching tenant, counted process-wide at the
    server), fire once per process, and ignore
    ``TORCHEVAL_TPU_CHAOS_RANK`` (the drill arms each host process with
    its own environment).

    **Ack actions** (fire in ``on_host_ack``, at the eval wire server's
    *deferred* ack-writer path — the asynchronous acks of the pipelined
    wire; neither kills the process):

    * ``"ack_delay"`` — hold the chosen submit's ack for
      ``TORCHEVAL_TPU_CHAOS_DELAY_S`` seconds before writing it: the
      batch is long applied, the producer's in-flight window stays
      occupied — a slow ack must stall only the window, never corrupt
      the watermark.
    * ``"ack_reorder"`` — write the chosen submit's ack AFTER the next
      ack on the same connection: acks arrive out of seq order, which
      the client's order-independent ack matching and monotonic
      durable-watermark fold must absorb bit-identically.

    Ack actions select their ack with ``TORCHEVAL_TPU_CHAOS_TENANT`` and
    ``TORCHEVAL_TPU_CHAOS_STEP`` (the 1-based index among *submit* acks
    for the matching tenant, counted process-wide), exactly like host
    actions, and fire once per process.

    **Router actions** (fire in ``on_router_op``, at the router's
    control-plane funnel):

    * ``"router_kill"`` — ``os._exit`` at the chosen router operation:
      the control plane vanishes mid-stream with its routing table,
      split topology, and replay buffers. Recovery is the journal's job
      (``EvalRouter(journal_dir=)``); the drill restarts the router in a
      fresh process and reconciles against the still-live hosts.

    Router actions select their moment with ``TORCHEVAL_TPU_CHAOS_TENANT``
    (``"*"`` = any tenant), ``TORCHEVAL_TPU_CHAOS_STEP`` (the 1-based
    index among matching hook calls, counted process-wide) and the
    optional ``TORCHEVAL_TPU_CHAOS_POINT`` (``"submit"`` /
    ``"migrate_exported"`` / … — ``"*"`` = any point, the default;
    ``"migrate_exported"`` is the nastiest: the tenant's wire state is
    exported but not yet adopted anywhere). Fire once per process.

    **Checkpoint actions** (fire in ``on_ckpt_saved``, immediately after
    ``resilience.save`` publishes a generation):

    * ``"ckpt_corrupt"`` — flip one payload byte (``state.npz``) of the
      just-published checkpoint, modelling silent media corruption of
      the newest generation: the next ``restore_latest_valid`` /
      ``attach(resume="auto")`` must quarantine it and fall back to the
      previous valid generation. The manifest (and its checksum record)
      stays intact, so the corruption is caught by verification, not by
      a missing file.

    Checkpoint actions select their save with
    ``TORCHEVAL_TPU_CHAOS_TENANT`` (a substring of the checkpoint path —
    the daemon's per-tenant directory carries the sanitized tenant id;
    ``"*"`` = any save) and ``TORCHEVAL_TPU_CHAOS_STEP`` (the 1-based
    index among matching saves, counted process-wide). Fire once per
    process.
``TORCHEVAL_TPU_CHAOS_RANK``
    Global process index the fault targets. Required for sync-funnel
    actions (other ranks never act); optional for ingestion actions (when
    set, only that rank injects — a multi-process serve test usually arms
    different per-rank environments instead).
``TORCHEVAL_TPU_CHAOS_ROUND``
    1-based index of the explicit collective round (every
    ``toolkit._allgather_stacked`` call counts one round, process-wide) at
    which a sync-funnel fault fires. A ``sync_and_compute`` is two rounds,
    so round 3 is "entering the descriptor exchange of the second sync".
    Required for sync-funnel actions.
``TORCHEVAL_TPU_CHAOS_TENANT``
    Tenant id an ingestion fault targets (``"*"`` = any tenant). Required
    for ingestion actions.
``TORCHEVAL_TPU_CHAOS_STEP``
    1-based per-tenant batch index at which the ingestion fault fires
    (each tenant's submissions count separately). Required for ingestion
    actions. The fault fires ONCE per process — one corrupted batch, like
    one preemption.
``TORCHEVAL_TPU_CHAOS_POISON``
    ``"nan"`` (default) or ``"shape"`` — see ``"poison"`` above.
``TORCHEVAL_TPU_CHAOS_DELAY_S``
    Straggler/producer-stall sleep, seconds (default 30).
``TORCHEVAL_TPU_CHAOS_EXIT_CODE``
    Exit code for ``kill`` (default 43), so a launcher can tell an injected
    death from a genuine crash.

The hooks live at the two funnels the corresponding real faults pass
through — every explicit cross-process collective round
(``toolkit._allgather_stacked``) and, in the JAX package, every serve
queue admission (``serve.daemon._submit``) — so the injection points are
the real fault surfaces, not mocks: surviving ranks execute the genuine
gloo or NCCL collective
and the genuine watchdog path, and a poisoned batch flows through the
genuine validation/quarantine machinery.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.obs import registry as _obs_registry
from torcheval_tpu_torch.obs import trace as _obs_trace

_logger = logging.getLogger(__name__)

_ENV_ARM = "TORCHEVAL_TPU_CHAOS"
_ENV_RANK = "TORCHEVAL_TPU_CHAOS_RANK"
_ENV_ROUND = "TORCHEVAL_TPU_CHAOS_ROUND"
_ENV_ACTION = "TORCHEVAL_TPU_CHAOS_ACTION"
_ENV_DELAY = "TORCHEVAL_TPU_CHAOS_DELAY_S"
_ENV_EXIT = "TORCHEVAL_TPU_CHAOS_EXIT_CODE"
_ENV_TENANT = "TORCHEVAL_TPU_CHAOS_TENANT"
_ENV_STEP = "TORCHEVAL_TPU_CHAOS_STEP"
_ENV_POISON = "TORCHEVAL_TPU_CHAOS_POISON"
_ENV_POINT = "TORCHEVAL_TPU_CHAOS_POINT"

_SYNC_ACTIONS = ("kill", "delay")
# load actions fire REPEATEDLY (every matching admitted batch), the rest
# of the ingest family one-shot; both share the ingest env contract
_LOAD_ACTIONS = ("load_spike", "hot_tenant")
_INGEST_ACTIONS = ("poison", "ingest_delay") + _LOAD_ACTIONS
_HOST_ACTIONS = ("host_kill", "host_partition", "ack_drop")
_ACK_ACTIONS = ("ack_delay", "ack_reorder")
_ROUTER_ACTIONS = ("router_kill",)
_CKPT_ACTIONS = ("ckpt_corrupt",)
_POISON_KINDS = ("nan", "shape")


class _ChaosConfig:
    __slots__ = (
        "rank",
        "round",
        "action",
        "delay_s",
        "exit_code",
        "tenant",
        "step",
        "poison",
        "point",
    )

    def __init__(
        self,
        action: str,
        *,
        rank: Optional[int] = None,
        rnd: Optional[int] = None,
        delay_s: float = 30.0,
        exit_code: int = 43,
        tenant: Optional[str] = None,
        step: Optional[int] = None,
        poison: str = "nan",
        point: str = "*",
    ):
        self.action = action
        self.rank = rank
        self.round = rnd
        self.delay_s = delay_s
        self.exit_code = exit_code
        self.tenant = tenant
        self.step = step
        self.poison = poison
        self.point = point


# resolved lazily on first hook; False = disarmed, None = not yet resolved
_config: Optional[object] = None
_rounds_seen = 0
_ingest_fired = False
_load_logged = False  # load_spike: trace/log once, fire every batch
_host_fired = False
_host_submits_seen: dict = {}  # tenant_id -> submit requests observed
_ack_fired = False
_acks_seen: dict = {}  # tenant_id -> submit acks observed
_router_fired = False
_router_ops_seen = 0  # matching router-op hook calls observed
_ckpt_fired = False
_ckpt_saves_seen = 0  # matching checkpoint publishes observed
_lock = threading.Lock()


def _process_rank() -> int:
    """This process's ``torch.distributed`` rank, 0 without a process group
    (the JAX package reads ``jax.process_index()``)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _resolve() -> object:
    """Parse the environment once. A malformed configuration disarms with a
    warning rather than raising — chaos must never be able to break a
    production job that merely inherited a stale variable."""
    global _config
    if os.environ.get(_ENV_ARM) != "1":
        _config = False
        return _config
    try:
        action = os.environ.get(_ENV_ACTION, "kill")
        delay_s = float(os.environ.get(_ENV_DELAY, "30"))
        exit_code = int(os.environ.get(_ENV_EXIT, "43"))
        if action in _SYNC_ACTIONS:
            _config = _ChaosConfig(
                action,
                rank=int(os.environ[_ENV_RANK]),
                rnd=int(os.environ[_ENV_ROUND]),
                delay_s=delay_s,
                exit_code=exit_code,
            )
        elif action in _INGEST_ACTIONS:
            poison = os.environ.get(_ENV_POISON, "nan")
            if poison not in _POISON_KINDS:
                raise ValueError(f"unknown poison kind {poison!r}")
            rank_env = os.environ.get(_ENV_RANK)
            _config = _ChaosConfig(
                action,
                rank=int(rank_env) if rank_env is not None else None,
                delay_s=delay_s,
                tenant=os.environ[_ENV_TENANT],
                step=int(os.environ[_ENV_STEP]),
                poison=poison,
            )
        elif action in _HOST_ACTIONS:
            _config = _ChaosConfig(
                action,
                exit_code=exit_code,
                tenant=os.environ[_ENV_TENANT],
                step=int(os.environ[_ENV_STEP]),
            )
        elif action in _ACK_ACTIONS:
            _config = _ChaosConfig(
                action,
                delay_s=delay_s,
                tenant=os.environ[_ENV_TENANT],
                step=int(os.environ[_ENV_STEP]),
            )
        elif action in _ROUTER_ACTIONS:
            _config = _ChaosConfig(
                action,
                exit_code=exit_code,
                tenant=os.environ[_ENV_TENANT],
                step=int(os.environ[_ENV_STEP]),
                point=os.environ.get(_ENV_POINT, "*"),
            )
        elif action in _CKPT_ACTIONS:
            _config = _ChaosConfig(
                action,
                tenant=os.environ[_ENV_TENANT],
                step=int(os.environ[_ENV_STEP]),
            )
        else:
            raise ValueError(f"unknown chaos action {action!r}")
    except (KeyError, ValueError) as e:
        _logger.warning("chaos hooks armed but misconfigured (%s); disarming.", e)
        _config = False
    return _config


def reset_for_tests() -> None:
    """Re-read the environment and restart the round/step bookkeeping
    (test hook)."""
    global _config, _rounds_seen, _ingest_fired, _host_fired, _ack_fired
    global _load_logged, _router_fired, _router_ops_seen
    global _ckpt_fired, _ckpt_saves_seen
    with _lock:
        _config = None
        _rounds_seen = 0
        _ingest_fired = False
        _load_logged = False
        _host_fired = False
        _host_submits_seen.clear()
        _ack_fired = False
        _acks_seen.clear()
        _router_fired = False
        _router_ops_seen = 0
        _ckpt_fired = False
        _ckpt_saves_seen = 0


def on_sync_round() -> None:
    """Called by ``toolkit._allgather_stacked`` before every explicit
    collective round. No-op unless armed for this process at this round."""
    cfg = _config
    if cfg is None:
        cfg = _resolve()
    if cfg is False or cfg.action not in _SYNC_ACTIONS:
        return
    global _rounds_seen
    with _lock:
        _rounds_seen += 1
        seen = _rounds_seen
    if _process_rank() != cfg.rank or seen != cfg.round:
        return
    if _obs_registry._enabled:
        # the injection is a flight-recorder moment: a per-rank trace (or
        # the pre-kill obs dump the fault tests write) shows exactly which
        # round the fault hit — a kill's event survives only if the rank's
        # snapshot was exported before os._exit, which is the delay/test
        # pattern; the delay action records and lives on
        _obs_trace.instant(
            "resilience.chaos",
            kind="chaos",
            action=cfg.action,
            rank=cfg.rank,
            round=seen,
        )
    if cfg.action == "kill":
        _logger.warning(
            "chaos: killing rank %d at sync round %d (exit %d)",
            cfg.rank,
            seen,
            cfg.exit_code,
        )
        # a preemption does not run atexit handlers or close collectives
        os._exit(cfg.exit_code)
    _logger.warning(
        "chaos: delaying rank %d at sync round %d by %.1fs",
        cfg.rank,
        seen,
        cfg.delay_s,
    )
    time.sleep(cfg.delay_s)


def _poison_args(args: Tuple, kind: str) -> Tuple:
    """Corrupt one batch's payload the way a broken client would.

    ``"nan"``: the first float-dtype argument (a torch tensor or anything
    with ``__array__``) is replaced with all-NaN of the same shape and
    dtype; a tensor's replacement is a clone on its device, so the caller's
    tensor is never written. ``"shape"``: the first argument with a leading
    axis of more than one row loses its last row, so the batch arrives with
    mismatched leading dims and update validation raises. If no argument
    qualifies, the batch passes through unchanged (and a warning says so: a
    chaos test that poisons nothing should fail loudly, not silently
    pass)."""
    out = list(args)
    if kind == "nan":
        for i, a in enumerate(out):
            if isinstance(a, torch.Tensor):
                if a.is_floating_point():
                    out[i] = a.clone().fill_(float("nan"))
                    return tuple(out)
                continue
            arr = np.asarray(a) if hasattr(a, "__array__") else None
            if arr is not None and arr.dtype.kind == "f":
                out[i] = np.full_like(arr, np.nan)
                return tuple(out)
    else:  # shape
        for i, a in enumerate(out):
            if isinstance(a, torch.Tensor):
                if a.ndim >= 1 and a.shape[0] > 1:
                    out[i] = a[:-1].clone()
                    return tuple(out)
                continue
            arr = np.asarray(a) if hasattr(a, "__array__") else None
            if arr is not None and arr.ndim >= 1 and arr.shape[0] > 1:
                out[i] = arr[:-1]
                return tuple(out)
    _logger.warning(
        "chaos: poison (%s) found no eligible argument; batch unchanged.",
        kind,
    )
    return tuple(out)


def ingest_armed() -> bool:
    """True when an ingestion action is armed for this process — the serve
    daemon's cheap gate for its chaos slow path (when False, ``submit``
    never calls :func:`on_ingest` at all)."""
    cfg = _config
    if cfg is None:
        cfg = _resolve()
    return cfg is not False and cfg.action in _INGEST_ACTIONS


def host_armed() -> bool:
    """True when a host action is armed for this process — the eval wire
    server's cheap gate (when False, request dispatch never calls
    :func:`on_host_request`)."""
    cfg = _config
    if cfg is None:
        cfg = _resolve()
    return cfg is not False and cfg.action in _HOST_ACTIONS


def on_host_request(op: str, tenant_id: Optional[str]) -> Optional[str]:
    """Called by the eval wire server before dispatching each request.

    Counts *submit* requests per tenant (process-wide, under the lock so
    concurrent connections cannot double-count one step). At the armed
    tenant's armed step: ``host_kill`` exits HERE (request never
    processed); ``"partition"`` tells the server to go silent from this
    request on; ``"ack_drop"`` tells it to process the request and call
    :func:`host_die` before acking. Fires once per process."""
    cfg = _config
    if cfg is None:
        cfg = _resolve()
    if cfg is False or cfg.action not in _HOST_ACTIONS:
        return None
    global _host_fired
    if _host_fired or op != "submit" or tenant_id is None:
        return None
    with _lock:
        if _host_fired:
            return None
        seen = _host_submits_seen.get(tenant_id, 0) + 1
        _host_submits_seen[tenant_id] = seen
        if seen != cfg.step or cfg.tenant not in ("*", tenant_id):
            return None
        _host_fired = True
    if _obs_registry._enabled:
        _obs_trace.instant(
            "resilience.chaos",
            kind="chaos",
            action=cfg.action,
            tenant=tenant_id,
            step=seen,
        )
    if cfg.action == "host_kill":
        host_die("host_kill")
    if cfg.action == "host_partition":
        _logger.warning(
            "chaos: host partitioned at tenant %r submit %d (TCP up, "
            "service silent).",
            tenant_id,
            seen,
        )
        return "partition"
    return "ack_drop"


def ack_armed() -> bool:
    """True when an ack action is armed for this process — the pipelined
    ack writer's cheap gate (when False, the deferred-ack path never
    calls :func:`on_host_ack` at all)."""
    cfg = _config
    if cfg is None:
        cfg = _resolve()
    return cfg is not False and cfg.action in _ACK_ACTIONS


def on_host_ack(op: str, tenant_id: Optional[str]) -> Optional[str]:
    """Called by the eval wire server's deferred ack writer before each
    pipelined ack leaves. Counts *submit*/*submit_many* acks per tenant
    (process-wide, under the lock). At the armed tenant's armed step it
    returns the armed action (``"ack_delay"`` / ``"ack_reorder"``) for
    the writer to enact — the hook itself never sleeps or kills, so the
    batch's application is already committed either way. Fires once per
    process."""
    cfg = _config
    if cfg is None:
        cfg = _resolve()
    if cfg is False or cfg.action not in _ACK_ACTIONS:
        return None
    global _ack_fired
    if (
        _ack_fired
        or op not in ("submit", "submit_many")
        or tenant_id is None
    ):
        return None
    with _lock:
        if _ack_fired:
            return None
        seen = _acks_seen.get(tenant_id, 0) + 1
        _acks_seen[tenant_id] = seen
        if seen != cfg.step or cfg.tenant not in ("*", tenant_id):
            return None
        _ack_fired = True
    if _obs_registry._enabled:
        _obs_trace.instant(
            "resilience.chaos",
            kind="chaos",
            action=cfg.action,
            tenant=tenant_id,
            step=seen,
        )
    _logger.warning(
        "chaos: %s at tenant %r submit ack %d", cfg.action, tenant_id, seen
    )
    return cfg.action


def ack_delay_s() -> float:
    """The armed ``ack_delay`` hold, seconds (the writer sleeps, not the
    hook — see :func:`on_host_ack`)."""
    cfg = _config
    return cfg.delay_s if isinstance(cfg, _ChaosConfig) else 30.0


def host_die(action: str) -> None:
    """The host-loss moment itself: no Python cleanup, no atexit, no
    flush of the daemon's state — exactly what a preempted VM leaves."""
    cfg = _config
    exit_code = cfg.exit_code if isinstance(cfg, _ChaosConfig) else 43
    _logger.warning(
        "chaos: killing host (%s, exit %d)", action, exit_code
    )
    os._exit(exit_code)


def router_armed() -> bool:
    """True when a router action is armed for this process — the
    router's cheap gate (when False, its control-plane paths never call
    :func:`on_router_op` at all)."""
    cfg = _config
    if cfg is None:
        cfg = _resolve()
    return cfg is not False and cfg.action in _ROUTER_ACTIONS


def on_router_op(point: str, tenant_id: Optional[str]) -> None:
    """Called by the router at its control-plane moments (``"submit"``
    per fan-out decision, ``"migrate_exported"`` between a migration's
    export and its adopt, …). Counts matching calls process-wide under
    the lock; at the armed count, ``router_kill`` exits HERE — the
    routing table, split topology and replay buffers die unsaved, and
    only the journal (fsync'd before every table mutation committed)
    survives. Fires once per process."""
    cfg = _config
    if cfg is None:
        cfg = _resolve()
    if cfg is False or cfg.action not in _ROUTER_ACTIONS:
        return
    global _router_fired, _router_ops_seen
    if _router_fired:
        return
    if cfg.point not in ("*", point):
        return
    if cfg.tenant not in ("*", tenant_id):
        return
    with _lock:
        if _router_fired:
            return
        _router_ops_seen += 1
        if _router_ops_seen != cfg.step:
            return
        _router_fired = True
    if _obs_registry._enabled:
        _obs_trace.instant(
            "resilience.chaos",
            kind="chaos",
            action=cfg.action,
            tenant=tenant_id,
            point=point,
            step=cfg.step,
        )
    _logger.warning(
        "chaos: killing router at %s op %d (tenant %r, exit %d)",
        point,
        cfg.step,
        tenant_id,
        cfg.exit_code,
    )
    os._exit(cfg.exit_code)


def ckpt_armed() -> bool:
    """True when a checkpoint action is armed for this process — the
    snapshot writer's cheap gate (when False, ``save`` never calls
    :func:`on_ckpt_saved` at all)."""
    cfg = _config
    if cfg is None:
        cfg = _resolve()
    return cfg is not False and cfg.action in _CKPT_ACTIONS


def on_ckpt_saved(ckpt_path: str) -> None:
    """Called by ``resilience.save`` immediately after it publishes a
    generation. At the armed save (``TORCHEVAL_TPU_CHAOS_TENANT`` as a
    path substring, ``TORCHEVAL_TPU_CHAOS_STEP`` the 1-based matching
    count), flips one ``state.npz`` payload byte in place — the newest
    generation is now silently corrupt, exactly what
    ``restore_latest_valid`` / ``attach(resume="auto")`` must quarantine
    and fall back from. Fires once per process."""
    cfg = _config
    if cfg is None:
        cfg = _resolve()
    if cfg is False or cfg.action not in _CKPT_ACTIONS:
        return
    global _ckpt_fired, _ckpt_saves_seen
    if _ckpt_fired:
        return
    if cfg.tenant != "*" and cfg.tenant not in ckpt_path:
        return
    with _lock:
        if _ckpt_fired:
            return
        _ckpt_saves_seen += 1
        if _ckpt_saves_seen != cfg.step:
            return
        _ckpt_fired = True
    payload = os.path.join(ckpt_path, "state.npz")
    try:
        with open(payload, "r+b") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size == 0:
                _logger.warning(
                    "chaos: ckpt_corrupt found an empty payload at %s; "
                    "nothing flipped.", payload,
                )
                return
            # inside the zip local-file header / first member: restore
            # fails verification (corrupt_payload / checksum_mismatch),
            # never "file missing" — the silent-bit-rot model
            offset = min(12, size - 1)
            f.seek(offset)
            byte = f.read(1)
            f.seek(offset)
            f.write(bytes([byte[0] ^ 0xFF]))
            f.flush()
            os.fsync(f.fileno())
    except OSError as e:
        _logger.warning(
            "chaos: ckpt_corrupt could not touch %s (%s); the drill "
            "should fail loudly, not silently pass.", payload, e,
        )
        return
    if _obs_registry._enabled:
        _obs_trace.instant(
            "resilience.chaos",
            kind="chaos",
            action=cfg.action,
            path=ckpt_path,
            step=cfg.step,
        )
    _logger.warning(
        "chaos: flipped one payload byte of %s (save %d).",
        ckpt_path,
        cfg.step,
    )


def on_ingest(tenant_id: str, step: int, args: Tuple) -> Tuple:
    """Called by the serve daemon at the queue boundary for a batch that
    PASSED admission (capacity and liveness checks) — a shed batch must
    never consume the one-shot fault. ``step`` is the 1-based index of the
    batch among the tenant's admitted batches, read under the daemon lock
    so concurrent producers cannot double-present one step. Returns the
    (possibly corrupted) args; may sleep first. No-op unless armed for an
    ingestion action matching this tenant and step. The fault fires once
    per process."""
    cfg = _config
    if cfg is None:
        cfg = _resolve()
    if cfg is False or cfg.action not in _INGEST_ACTIONS:
        return args
    if cfg.action in _LOAD_ACTIONS:
        # load_spike/hot_tenant: repeated-fire — every
        # admitted batch of the armed tenant from the armed step ON pays
        # delay_s of synthetic service time. Never one-shot, never
        # corrupting: the elapsed submit (including this sleep) feeds
        # the daemon's submit EWMA and serve.submit.latency histogram,
        # so the host's load_report reads deterministically hot while
        # every metric result stays bit-identical to a fault-free run.
        global _load_logged
        if step < cfg.step or cfg.tenant not in ("*", tenant_id):
            return args
        if cfg.rank is not None and _process_rank() != cfg.rank:
            return args
        with _lock:
            first = not _load_logged
            _load_logged = True
        if first:
            if _obs_registry._enabled:
                _obs_trace.instant(
                    "resilience.chaos",
                    kind="chaos",
                    action=cfg.action,
                    tenant=tenant_id,
                    step=step,
                )
            _logger.warning(
                "chaos: load spike on tenant %r from batch %d "
                "(+%.3fs per batch)",
                tenant_id,
                step,
                cfg.delay_s,
            )
        time.sleep(cfg.delay_s)
        return args
    global _ingest_fired
    if (
        _ingest_fired
        or step != cfg.step
        or cfg.tenant not in ("*", tenant_id)
    ):
        return args
    if cfg.rank is not None and _process_rank() != cfg.rank:
        return args
    with _lock:
        if _ingest_fired:
            return args
        _ingest_fired = True
    if _obs_registry._enabled:
        _obs_trace.instant(
            "resilience.chaos",
            kind="chaos",
            action=cfg.action,
            tenant=tenant_id,
            step=step,
        )
    if cfg.action == "ingest_delay":
        _logger.warning(
            "chaos: delaying ingestion of tenant %r batch %d by %.1fs",
            tenant_id,
            step,
            cfg.delay_s,
        )
        time.sleep(cfg.delay_s)
        return args
    _logger.warning(
        "chaos: poisoning tenant %r batch %d (%s)",
        tenant_id,
        step,
        cfg.poison,
    )
    return _poison_args(args, cfg.poison)
