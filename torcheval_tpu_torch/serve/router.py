"""`EvalRouter`: tenant placement, health probing, and cross-host migration.

JAX counterpart: ``torcheval_tpu/serve/router.py``. The router speaks the
serve wire only, so it fronts hosts of either package; its placement
draws, load folding and scaling decisions are the JAX router's, value for
value, and its journal (``journal.py``) is the JAX format byte for byte.
The one device decision is the split tenant's merged compute, which
rebuilds and restores every replica's collection in the router's own
process: on ``device`` (``cuda:0`` unless the caller asks for another;
``device="cpu"`` merges on the CPU, and without a GPU the default raises
instead of falling back).

A router fronts N eval-service hosts (each an :class:`EvalServer` +
:class:`EvalDaemon` pair sharing one checkpoint root) with one
:class:`~torcheval_tpu_torch.serve.EvalClient` per endpoint, and makes the
death of any single host a routine event (host loss and draining are
absorbed, not outages):

* **placement** — tenants place by rendezvous (highest-random-weight)
  hashing of ``tenant_id`` over the *alive* endpoint set: deterministic,
  coordination-free, and minimal-movement (a host's death moves only its
  own tenants, never reshuffles survivors);
* **health probing** — ``health()`` probes every alive host's
  ``daemon.health()`` over the wire; a probe failure (or any transport
  failure on a tenant op) marks the host dead and triggers migration;
* **failure migration** — a dead host's tenants re-``attach`` on a
  surviving host with ``resume="auto"``: the daemon restores each
  tenant's latest checkpoint from the shared root (``resilience.save``'s
  contract is location-independent — evict-on-idle and flushes already
  write there) and re-arms its dedup watermark from the checkpoint
  manifest; the router then replays the client-side replay buffer's
  un-durable tail. Acked-and-checkpointed batches come back through the
  checkpoint, un-acked ones through replay, and seq dedup absorbs the
  overlap — post-migration computes match a fault-free oracle
  bit-identically;
* **graceful drain** — ``drain(endpoint)`` asks the host to
  checkpoint-and-evict every tenant (it stops admitting immediately),
  then migrates them the same way; use it before planned maintenance so
  the "un-acked tail" is empty and the blackout is one restore long.

Transport knobs ride through ``**client_kwargs`` to every per-host
client: ``pipeline_depth=`` turns on the deferred-ack submit
pipelining against hosts that grant it (a migrated tenant's replay
drains through the ordinary lock-step path first, then new submits
pipeline to the survivor), and ``local_transport=False`` forces TCP
even when a fronted server shares this process (the bench's migration
leg pins it off so the blackout measured is the wire's).

Observability: ``serve.router.migrations{reason=}``,
``serve.router.replays{tenant=}`` (counted at the replaying client),
``serve.router.probe_failures{endpoint=}``, plus a
``serve.router.migrate`` span per migrated host (a migration-blackout
bar in the Chrome trace).

Fleet telemetry: ``subscribe_obs()`` opens one obs push
stream per alive host (``EvalClient.subscribe_obs`` — delta snapshots +
``load_report`` on the server's timer, degrading to ``health()`` polling
against old peers); the router folds each host's deltas into a
:class:`~torcheval_tpu_torch.obs.DeltaAccumulator` and keeps its latest load
report. ``fleet_status()`` serves the folded view with staleness marking
(a host whose last push is older than ``stale_after_s`` — default three
push intervals — is ``stale`` BEFORE the failure detector evicts it);
``fleet_chrome_trace()`` merges every host's pushed timeline events into
one Chrome trace, pid per host. None of it adds collective rounds: the
stream rides the serve wire, not the toolkit funnel.

Elastic fleet: the fleet grows, shrinks and rebalances under load
instead of capping throughput at one hot host:

* **load-aware placement** — ``_place`` is *weighted* rendezvous: each
  alive endpoint's rendezvous draw is scored ``-w / ln(u)`` (highest
  score wins) where ``u`` is the tenant-endpoint hash mapped into (0,1)
  and the weight ``w`` folds that host's latest fresh ``load_report``
  (queue utilization, tenant-slot utilization, submit p99/EWMA against
  ``latency_target_s``, optional HBM budget). With no load signal every
  weight is 1 and the argmax is EXACTLY the classic unweighted
  rendezvous (a monotone transform of the same draw), so placement
  stays deterministic and minimal-movement; hosts whose fresh report
  says ``draining`` — or whose subscribed stream went silent past the
  staleness horizon — are ineligible for NEW tenants;
* **rebalancing** — ``rebalance()`` (one pass; ``start_rebalancer()``
  runs it on a timer) migrates tenants off hot hosts through the SAME
  checkpoint+replay machinery as failure migration, made loss-proof for
  a live source: flush (durable resume point) → ``export_tenant`` (wire
  state + booked tail carried off; racing submits absorb through the
  reroute-grace window) → ``drop_tenant`` on the source → re-attach
  ``resume="auto"`` + ``adopt_tenant`` on the target. Hysteresis knobs
  (``hot_load`` threshold, minimum ``improvement`` gap, per-tenant
  ``min_dwell_s``, ``max_moves`` per pass) bound movement so the fleet
  provably never thrashes;
* **hot-tenant splitting** — ``split_tenant(tid, n)`` shards one
  tenant's stream across N replica tenants (``tid``, ``tid@r1``, …),
  each a first-class routed tenant with its OWN seq namespace (the
  replica id IS the dedup key, so exactly-once holds per replica and
  failover/migration work per-replica unchanged). ``submit`` fans out
  by a stable hash of the split ordinal; ``compute`` flushes every
  replica, rebuilds each collection through the daemon's own
  ``build_collection`` path, restores the flush checkpoints, and merges
  — ``merge_collections`` for sliced tenants (cohorts re-keyed by
  original id), per-member ``merge_state`` otherwise — bit-identical to
  the single-stream oracle;
* **autoscale hooks** — ``add_host()`` / ``remove_host()`` (= drain +
  forget) at runtime, and ``autoscale_step(policy)`` drives a pluggable
  :class:`ScalingPolicy` from ``fleet_status()``'s aggregate
  ``headroom`` scalar, so a bench-driven simulator or an external
  orchestrator grows the fleet under load.

New instruments: ``serve.router.rebalances{endpoint=}`` (one per
completed rebalance move, alongside
``serve.router.migrations{reason=rebalance}``),
``serve.router.splits{tenant=}``, and the ``serve.fleet.headroom``
gauge recorded by ``fleet_status()``.

Durable control plane: with ``journal_dir=`` every
control-plane mutation — placement, migration move, split, drain, host
add/remove — appends one fsync'd record to a
:class:`~torcheval_tpu_torch.serve.journal.RouterJournal` before the call
returns (submits never touch it; seq watermarks are the hosts' to
keep). A new router constructed over the same ``journal_dir`` replays
the journal and then **reconciles** against the live fleet via the
``list_tenants`` wire op: journaled tenants still attached are
*adopted* in place (client seq state re-seeded from the host's
``last_seq`` — zero blackout beyond the probe), tenants whose host died
while the router was down are *re-placed* through the ordinary
``attach(resume="auto")`` checkpoint machinery, live tenants the
journal never heard of are *orphan-adopted* from the attach-time
spec/knobs each server records, a tenant found attached on TWO hosts
(killed mid-migration) keeps the copy that advanced further and the
stale one is dropped without a checkpoint, and split fan-out namespaces
are reconstructed exactly — the fan-out ordinal is the sum of replica
``last_seq``\\ s, because every parent submit bumps exactly one
replica's seq by one. Outcomes count into
``serve.router.recoveries{outcome=}`` and the whole pass is summarized
in :attr:`EvalRouter.last_recovery` (the drill's blackout artifact).
"""

from __future__ import annotations

import hashlib
import logging
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from torcheval_tpu_torch.obs import registry as _obs
from torcheval_tpu_torch.obs import trace as _trace
from torcheval_tpu_torch.resilience import chaos as _chaos
from torcheval_tpu_torch.serve.client import EvalClient
from torcheval_tpu_torch.serve.errors import AdmissionError, ServeError, WireError
from torcheval_tpu_torch.serve.journal import RouterJournal

_logger = logging.getLogger(__name__)

__all__ = ["EvalRouter", "HeadroomScalingPolicy", "ScalingPolicy"]


def _replica_id(tenant_id: str, k: int) -> str:
    """Replica ``k``'s tenant id. Replica 0 IS the original tenant (its
    id, state, and checkpoint lineage are unchanged by a split); higher
    replicas get a namespaced id, which makes the replica id part of the
    wire dedup key for free — each replica runs its own monotonic seq."""
    return tenant_id if k == 0 else f"{tenant_id}@r{k}"


class _RoutedTenant:
    __slots__ = (
        "spec",
        "knobs",
        "endpoint",
        "placed_at",
        "replicas",
        "parent",
        "split_next",
    )

    def __init__(
        self,
        spec: Any,
        knobs: Dict[str, Any],
        endpoint: str,
        *,
        parent: Optional[str] = None,
    ):
        self.spec = spec
        self.knobs = knobs
        self.endpoint = endpoint
        self.placed_at = time.monotonic()  # rebalance dwell clock
        self.replicas: Optional[List[str]] = None  # split parent only
        self.parent = parent  # set on replicas k >= 1
        self.split_next = 0  # fan-out ordinal (split parent only)


class EvalRouter:
    """Route tenants across eval-service hosts; survive any one of them.

    ``endpoints`` are ``"host:port"`` strings (or ``(host, port)``
    tuples); ``client_kwargs`` configure every per-host
    :class:`EvalClient` (deadlines, breaker, replay capacity — all
    validated there). The hosts must share one checkpoint root (each
    daemon's ``evict_dir``) for migration to have a resume source.
    ``device`` is where a split tenant's replicas are rebuilt and merged
    (``None`` = ``cuda:0``, which raises without a GPU; pass ``"cpu"`` to
    merge on the CPU).

    Thread-safe for the many-producers shape: submits for different
    tenants proceed concurrently (per-tenant client locks); migration
    holds the router lock so a failing host is migrated exactly once.
    """

    def __init__(
        self,
        endpoints: Sequence[Any],
        *,
        client_factory: Any = EvalClient,
        reroute_grace_s: float = 60.0,
        probe_timeout_s: Optional[float] = 5.0,
        latency_target_s: float = 1.0,
        hbm_budget_bytes: Optional[int] = None,
        journal_dir: Optional[str] = None,
        device: Any = None,
        **client_kwargs: Any,
    ) -> None:
        if not endpoints:
            raise ValueError("EvalRouter needs at least one endpoint.")
        from torcheval_tpu_torch.metrics.toolkit import _check_timeout_s
        from torcheval_tpu_torch.utils.devices import canonical_device

        self._device = canonical_device(device)

        for knob, value in (
            ("reroute_grace_s", reroute_grace_s),
            ("probe_timeout_s", probe_timeout_s),
            ("latency_target_s", latency_target_s),
        ):
            try:
                _check_timeout_s(value)
            except ValueError as e:
                raise ValueError(f"{knob}: {e}") from None
        if reroute_grace_s is None:
            raise ValueError("reroute_grace_s must be a positive number.")
        if latency_target_s is None:
            raise ValueError("latency_target_s must be a positive number.")
        if hbm_budget_bytes is not None and (
            not isinstance(hbm_budget_bytes, int) or hbm_budget_bytes < 1
        ):
            raise ValueError(
                f"hbm_budget_bytes must be a positive int or None, got "
                f"{hbm_budget_bytes!r}."
            )
        self._reroute_grace_s = float(reroute_grace_s)
        self._probe_timeout_s = probe_timeout_s
        # load-score knobs: submit p99 at/above the latency
        # target reads as full pressure; HBM pressure participates only
        # when a budget is declared
        self._latency_target_s = float(latency_target_s)
        self._hbm_budget_bytes = hbm_budget_bytes
        # kept so add_host() can mint new per-host clients at runtime
        # with the exact construction the initial endpoints got
        self._client_factory = client_factory
        self._client_kwargs = dict(client_kwargs)
        self._clients: Dict[str, EvalClient] = {}
        for ep in endpoints:
            client = client_factory(ep, **client_kwargs)
            self._clients[client.endpoint] = client
        if len(self._clients) != len(endpoints):
            raise ValueError(f"duplicate endpoints in {endpoints!r}.")
        self._alive = set(self._clients)
        self._tenants: Dict[str, _RoutedTenant] = {}
        self._lock = threading.RLock()
        # endpoints whose migration is in flight: the lock guards only
        # the routing tables; migration's network work (attach + restore
        # + replay per tenant) runs OUTSIDE it so one dying host never
        # stalls traffic to healthy hosts. _cv wakes threads waiting for
        # an in-flight migration to finish.
        self._cv = threading.Condition(self._lock)
        self._migrating: set = set()
        # fleet telemetry: per-endpoint folded obs state,
        # guarded by its own lock — push callbacks run on subscriber
        # threads and must never contend with migration's router lock
        self._fleet_lock = threading.Lock()
        self._obs_subs: Dict[str, Any] = {}
        self._fleet: Dict[str, Dict[str, Any]] = {}
        self._obs_interval_s: Optional[float] = None
        self._stale_after_s: Optional[float] = None
        self._fleet_max_events = 4096
        # background rebalancer
        self._rebalance_thread: Optional[threading.Thread] = None
        self._rebalance_stop = threading.Event()
        # durable control plane: endpoints taken out of the
        # alive set by an explicit drain stay out across a recovery (a
        # DEAD endpoint, by contrast, is re-derived by probing — the
        # journal records intent, the fleet records reality)
        self._drained: set = set()
        self._journal: Optional[RouterJournal] = None
        # the last recovery pass's summary (outcomes, duration, fleet),
        # None for a journal-less or genuinely cold start
        self.last_recovery: Optional[Dict[str, Any]] = None
        if journal_dir is not None:
            self._journal = RouterJournal(
                journal_dir, snapshot_fn=self._journal_state
            )
            self._recover()

    # -------------------------------------------------------------- journal
    def _journal_append(self, kind: str, **fields: Any) -> None:
        """Durably record one control-plane mutation. A journal write
        failure (disk full, dir removed) is logged, never raised — the
        fleet keeps serving and the gap heals at the next recovery's
        reconciliation pass (orphan adoption covers unjournaled
        placements)."""
        if self._journal is None:
            return
        try:
            self._journal.append(kind, **fields)
        except (OSError, ValueError, TypeError) as e:
            _logger.error(
                "router: journal append (%s) failed: %s — continuing "
                "unjournaled; the next recovery reconciles the gap.",
                kind,
                e,
            )

    def _journal_state(self) -> Dict[str, Any]:
        """The full routing table as one compactable snapshot."""
        with self._lock:
            return {
                "tenants": {
                    tid: {
                        "endpoint": rec.endpoint,
                        "spec": rec.spec,
                        "knobs": rec.knobs,
                        "parent": rec.parent,
                        "replicas": rec.replicas,
                    }
                    for tid, rec in self._tenants.items()
                },
                "endpoints": sorted(self._clients),
                "drained": sorted(self._drained),
            }

    def _recover(self) -> None:
        """Rebuild the routing table from the journal, then reconcile it
        against the live fleet (module docstring: adopt / re-place /
        orphan-adopt / drop, split reconstruction). Runs once, from the
        constructor, before the router serves anything — the wall-clock
        of this method IS the control-plane blackout."""
        t0 = time.monotonic()
        snapshot, records = self._journal.replay()
        expected: Dict[str, Dict[str, Any]] = {}
        known_eps = set(self._clients)
        drained: set = set()
        if snapshot:
            for tid, meta in (snapshot.get("tenants") or {}).items():
                expected[tid] = dict(meta)
            known_eps |= set(snapshot.get("endpoints") or ())
            drained |= set(snapshot.get("drained") or ())
        for r in records:
            kind = r.get("kind")
            if kind == "place":
                expected[r["tenant"]] = {
                    "endpoint": r.get("endpoint"),
                    "spec": r.get("spec"),
                    "knobs": r.get("knobs") or {},
                    "parent": r.get("parent"),
                    "replicas": None,
                }
            elif kind == "remove":
                expected.pop(r.get("tenant"), None)
            elif kind == "move":
                meta = expected.get(r.get("tenant"))
                if meta is not None:
                    meta["endpoint"] = r.get("endpoint")
            elif kind == "split":
                meta = expected.get(r.get("tenant"))
                if meta is not None:
                    meta["replicas"] = list(r.get("replicas") or ())
            elif kind == "host_add":
                known_eps.add(r.get("endpoint"))
                drained.discard(r.get("endpoint"))
            elif kind == "host_remove":
                known_eps.discard(r.get("endpoint"))
                drained.discard(r.get("endpoint"))
            elif kind == "host_drain":
                drained.add(r.get("endpoint"))
            # unknown kinds: a newer writer's record — skip, never crash
        # endpoints the journal knows that the constructor was not given
        # (hosts added at runtime before the crash) get clients minted
        # with the same factory/kwargs
        for ep in sorted(e for e in known_eps if e and e not in self._clients):
            try:
                client = self._client_factory(ep, **self._client_kwargs)
            except (ValueError, OSError) as e:
                _logger.warning(
                    "router recovery: cannot mint a client for journaled "
                    "endpoint %s: %s", ep, e,
                )
                continue
            self._clients[client.endpoint] = client
        # probe: aliveness comes from the fleet, not the journal — a
        # host that died AND restarted while the router was down is
        # simply alive again; only an explicit drain survives recovery
        self._drained = drained & set(self._clients)
        alive: set = set()
        live: Dict[str, Dict[str, Any]] = {}
        stale_copies: List[Any] = []
        for ep in sorted(self._clients):
            if ep in self._drained:
                continue
            try:
                tenants = self._clients[ep].list_tenants(
                    timeout_s=self._probe_timeout_s, attempts=1
                )
            except (WireError, ServeError) as e:
                if _obs._enabled:
                    _obs.counter(
                        "serve.router.probe_failures", endpoint=ep
                    )
                _logger.warning(
                    "router recovery: endpoint %s did not answer the "
                    "reconciliation probe (%s); its tenants re-place "
                    "from checkpoints.", ep, e,
                )
                continue
            alive.add(ep)
            for tid, info in tenants.items():
                cur = dict(info or {})
                cur["endpoint"] = ep
                prior = live.get(tid)
                if prior is None:
                    live[tid] = cur
                    continue
                # attached on TWO hosts: a migration was mid-flight when
                # the router died. Keep the copy that advanced further;
                # the stale one is dropped WITHOUT a checkpoint so it
                # cannot publish a zombie generation.
                keep, stale = (
                    (cur, prior)
                    if int(cur.get("last_seq") or 0)
                    >= int(prior.get("last_seq") or 0)
                    else (prior, cur)
                )
                live[tid] = keep
                stale_copies.append((tid, stale["endpoint"]))
        self._alive = alive
        outcomes: Dict[str, int] = {}

        def _count(outcome: str) -> None:
            outcomes[outcome] = outcomes.get(outcome, 0) + 1
            if _obs._enabled:
                _obs.counter("serve.router.recoveries", outcome=outcome)

        for tid, ep in stale_copies:
            try:
                self._clients[ep].drop_tenant(tid, checkpoint=False)
            except (ServeError, WireError) as e:
                _logger.warning(
                    "router recovery: stale copy of %r on %s did not "
                    "release cleanly: %s", tid, ep, e,
                )
            _count("stale_dropped")
        # torn-split rollback: a replica whose parent never committed a
        # split record is the debris of a mid-split crash — the split
        # itself is atomic, so the replica is detached, matching the
        # crash-free rollback path of split_tenant
        for tid in sorted(expected):
            meta = expected[tid]
            parent = meta.get("parent")
            if not parent:
                continue
            pmeta = expected.get(parent)
            committed = bool(
                pmeta
                and pmeta.get("replicas")
                and tid in pmeta["replicas"]
            )
            if committed:
                continue
            expected.pop(tid)
            info = live.pop(tid, None)
            if info is not None:
                try:
                    self._clients[info["endpoint"]].drop_tenant(
                        tid, checkpoint=False
                    )
                except (ServeError, WireError):
                    pass
            _count("split_rolled_back")
        seqs: Dict[str, int] = {}
        for tid in sorted(expected):
            meta = expected[tid]
            knobs = dict(meta.get("knobs") or {})
            info = live.pop(tid, None)
            if info is not None:
                # still attached where (or wherever) the fleet holds it:
                # adopt in place, re-seeding this router's client-side
                # seq cursor from the host's watermark
                rec = _RoutedTenant(
                    meta.get("spec"),
                    knobs,
                    info["endpoint"],
                    parent=meta.get("parent"),
                )
                self._tenants[tid] = rec
                seqs[tid] = int(info.get("last_seq") or 0)
                self._clients[info["endpoint"]].adopt_attached(
                    tid, seqs[tid]
                )
                _count("adopted")
                continue
            # its host died while the router was down: re-place from the
            # shared checkpoint root. The replay buffer died with the
            # old router, so the resume point is the last DURABLE
            # watermark — producers resubmit above it, dedup absorbs
            # any overlap.
            place_knobs = dict(knobs)
            place_knobs["resume"] = "auto"
            try:
                ep = self._attach_anywhere(
                    tid, meta.get("spec"), place_knobs
                )
            except (ServeError, WireError, AdmissionError) as e:
                _logger.error(
                    "router recovery: journaled tenant %r could not be "
                    "re-placed (%s); dropping it from the routing "
                    "table.", tid, e,
                )
                _count("dropped")
                continue
            self._tenants[tid] = _RoutedTenant(
                meta.get("spec"), knobs, ep, parent=meta.get("parent")
            )
            # the freshly attached client state carries the restored
            # watermark — read it back for split reconstruction
            state = self._clients[ep]._tenants.get(tid)
            seqs[tid] = int(state.durable_seq) if state is not None else 0
            _count("replaced")
        # orphans: live tenants the journal never heard of (attached in
        # the crash window before their journal record landed, or placed
        # behind the router's back). Adoptable only when the host
        # recorded the attach-time spec; an old host's degraded
        # list_tenants has none, so the tenant stays unrouted — loudly.
        for tid in sorted(live):
            info = live[tid]
            if info.get("spec") is None:
                _logger.warning(
                    "router recovery: live tenant %r on %s carries no "
                    "attach spec (old host?); leaving it unrouted.",
                    tid, info["endpoint"],
                )
                _count("orphan_skipped")
                continue
            self._tenants[tid] = _RoutedTenant(
                info["spec"],
                dict(info.get("knobs") or {}),
                info["endpoint"],
            )
            seqs[tid] = int(info.get("last_seq") or 0)
            self._clients[info["endpoint"]].adopt_attached(
                tid, seqs[tid]
            )
            _count("orphan_adopted")
        # split reconstruction: surviving replicas re-form the fan-out
        # set, and the fan-out ordinal is reconciliation-derived — every
        # parent submit bumped exactly one replica's seq by one, so the
        # ordinal is the sum of replica watermarks, exactly
        for tid, meta in expected.items():
            replicas = meta.get("replicas")
            rec = self._tenants.get(tid)
            if not replicas or rec is None:
                continue
            present = [r for r in replicas if r in self._tenants]
            rec.replicas = present if len(present) >= 2 else None
            rec.split_next = sum(seqs.get(r, 0) for r in present)
        duration_s = time.monotonic() - t0
        self.last_recovery = {
            "outcomes": outcomes,
            "duration_s": duration_s,
            "alive": sorted(alive),
            "drained": sorted(self._drained),
            "tenants": len(self._tenants),
            "journal_records": len(records),
        }
        if _obs._enabled:
            _trace.instant(
                "serve.router.recovered",
                kind="router",
                duration_s=duration_s,
                tenants=len(self._tenants),
            )
        _logger.info(
            "router: recovered from journal in %.3fs — %s (alive: %s).",
            duration_s,
            outcomes or "cold start",
            sorted(alive),
        )
        # fold the reconciled table into one snapshot so the next
        # recovery replays the OUTCOME, not the pre-crash history
        try:
            self._journal.compact(self._journal_state())
        except (OSError, ValueError) as e:
            _logger.error(
                "router: post-recovery journal compaction failed: %s", e
            )

    # ------------------------------------------------------------ placement
    def _host_load(self, report: Optional[Dict[str, Any]]) -> float:
        """Fold one schema-1 ``load_report`` into a scalar load in
        [0, 0.999]: the max of queue utilization, tenant-slot
        utilization, submit latency pressure (p99, else EWMA, against
        ``latency_target_s``), and — when ``hbm_budget_bytes`` is set —
        HBM pressure. Max (not mean): placement must route around the
        binding constraint, whichever it is."""
        if not report:
            return 0.0
        pressures = [0.0]
        queue = report.get("queue") or {}
        qcap = queue.get("capacity") or 0
        if qcap:
            pressures.append(
                float(queue.get("depth", 0)) / float(qcap)
            )
        capacity = report.get("capacity") or {}
        max_t = capacity.get("max_tenants") or 0
        if max_t:
            pressures.append(
                float(capacity.get("active_tenants", 0)) / float(max_t)
            )
        latency = report.get("latency") or {}
        p99 = (
            latency.get("submit_p99_s")
            or latency.get("submit_ewma_s")
            or 0.0
        )
        pressures.append(float(p99) / self._latency_target_s)
        if self._hbm_budget_bytes:
            hbm = report.get("hbm") or {}
            pressures.append(
                float(hbm.get("bytes_sum", 0.0))
                / float(self._hbm_budget_bytes)
            )
        return min(0.999, max(0.0, max(pressures)))

    def _fleet_loads(self) -> Dict[str, Dict[str, Any]]:
        """Per-alive-endpoint load view from the folded fleet state:
        ``{ep: {"load": float|None, "draining": bool, "suspect":
        bool}}``. Only a FRESH report (inside the staleness horizon)
        contributes ``load`` and ``draining`` — a stale number must not
        weight placement. ``suspect`` marks a host whose subscribed
        stream delivered at least once and then went quiet past the
        horizon: ineligible for new tenants until the failure detector
        rules (a host never heard from carries no signal and stays
        eligible — no signal is not bad signal)."""
        horizon = self._stale_after_s if self._stale_after_s else 3.0
        now = time.monotonic()
        out: Dict[str, Dict[str, Any]] = {}
        alive = self.alive
        with self._fleet_lock:
            for ep in alive:
                rec = self._fleet.get(ep)
                subscribed = ep in self._obs_subs
                report = rec["report"] if rec else None
                age = (
                    now - rec["received_at"]
                    if rec is not None and rec["received_at"]
                    else None
                )
                fresh = age is not None and age <= horizon
                out[ep] = {
                    "load": (
                        self._host_load(report)
                        if fresh and report is not None
                        else None
                    ),
                    "draining": bool(
                        fresh and report and report.get("draining")
                    ),
                    "suspect": bool(
                        subscribed and age is not None and not fresh
                    ),
                }
        return out

    def _place(self, tenant_id: str, *, exclude: Any = ()) -> str:
        """Weighted rendezvous placement over the alive set: every
        endpoint's hash draw ``u`` is scored ``-w / ln(u)`` and the
        highest score wins, with weight ``w = 1 - load`` folded from the
        host's latest fresh ``load_report``. With no load signal every
        weight is 1 and the argmax is EXACTLY classic
        highest-random-weight hashing (monotone transform of the same
        draw) — deterministic for a given alive set, minimal-movement
        when hosts die. Hosts whose fresh report says ``draining``, or
        whose subscribed stream went silent past the staleness horizon,
        are ineligible for NEW tenants (unless that would empty the
        candidate set — a merely-quiet fleet must still place)."""
        with self._lock:
            alive = sorted(self._alive)
        if exclude:
            alive = [ep for ep in alive if ep not in exclude]
        if not alive:
            raise ServeError(
                "no_hosts", "every endpoint is dead or drained."
            )
        info = self._fleet_loads()
        eligible = [
            ep
            for ep in alive
            if ep not in info
            or not (info[ep]["draining"] or info[ep]["suspect"])
        ] or alive
        best, best_score = None, -math.inf
        for ep in eligible:
            load = info.get(ep, {}).get("load")
            weight = max(1e-3, 1.0 - (load or 0.0))
            digest = hashlib.sha256(
                f"{tenant_id}@{ep}".encode()
            ).digest()
            # first 8 digest bytes -> u in (0,1); ln(u) < 0, so the
            # score is positive and monotone in u at equal weights
            u = (int.from_bytes(digest[:8], "big") + 0.5) / 2.0**64
            score = -weight / math.log(u)
            if score > best_score:
                best, best_score = ep, score
        return best

    @property
    def endpoints(self) -> List[str]:
        return sorted(self._clients)

    @property
    def alive(self) -> List[str]:
        with self._lock:
            return sorted(self._alive)

    def placement(self) -> Dict[str, str]:
        """Current ``{tenant_id: endpoint}`` map."""
        with self._lock:
            return {t: rec.endpoint for t, rec in self._tenants.items()}

    def close(self) -> None:
        self.stop_rebalancer()  # before the clients its moves would use
        self.unsubscribe_obs()
        for client in self._clients.values():
            client.close()
        if self._journal is not None:
            self._journal.close()

    def __enter__(self) -> "EvalRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ tenant api
    def attach(
        self, tenant_id: str, spec: Dict[str, Any], **knobs: Any
    ) -> str:
        """Place and attach one tenant; returns the chosen endpoint.
        ``spec``/``knobs`` are recorded so a migration can re-attach the
        tenant identically elsewhere."""
        with self._lock:
            if tenant_id in self._tenants:
                raise ServeError(
                    "duplicate_tenant",
                    f"tenant {tenant_id!r} is already routed.",
                )
        ep = self._attach_anywhere(tenant_id, spec, knobs)
        with self._lock:
            self._tenants[tenant_id] = _RoutedTenant(spec, dict(knobs), ep)
        # journaled AFTER the commit: a crash in between leaves a live,
        # unjournaled tenant — exactly what recovery's orphan adoption
        # reconciles (journaling first would instead fabricate a tenant
        # the caller was never told about)
        self._journal_append(
            "place",
            tenant=tenant_id,
            endpoint=ep,
            spec=spec,
            knobs=dict(knobs),
            parent=None,
        )
        return ep

    def _attach_anywhere(
        self,
        tenant_id: str,
        spec: Dict[str, Any],
        knobs: Dict[str, Any],
        *,
        exclude: Any = (),
    ) -> str:
        """Place-and-attach with dead/draining-host absorption; returns
        the endpoint that admitted the tenant. Does NOT touch the
        routing table — callers record the placement."""
        while True:
            ep = self._place(tenant_id, exclude=exclude)
            try:
                self._clients[ep].attach(tenant_id, spec, **knobs)
            except WireError as e:
                if not e.retryable:
                    raise
                self._host_failed(ep, cause=e)
                continue
            except AdmissionError as e:
                if e.reason != "draining":
                    raise
                # the rendezvous pick is mid-decommission: treat it like
                # a failed host (same single-flight migration machinery;
                # if the router's own drain() already owns the move this
                # just waits for it) and re-place among the survivors
                self._host_failed(ep, cause=e)
                continue
            return ep

    def _routed(self, tenant_id: str) -> _RoutedTenant:
        with self._lock:
            rec = self._tenants.get(tenant_id)
        if rec is None:
            raise ServeError(
                "unknown_tenant",
                f"tenant {tenant_id!r} is not routed; attach it first.",
            )
        return rec

    def _with_failover(self, tenant_id: str, op) -> Any:
        """Run one tenant op against its current host; on a transport
        failure, migrate the host's tenants and run the op once more on
        the new placement (compute/flush/detach are idempotent). A second
        transport failure surfaces. The in-flight-migration window
        (``tenant_migrated`` / client-side ``unknown_tenant`` for a
        still-routed tenant) re-routes within ``reroute_grace_s``, like
        ``submit``."""
        wire_failures = 0
        deadline = time.monotonic() + self._reroute_grace_s
        sleep_s = 0.02
        while True:
            rec = self._routed(tenant_id)
            client = self._clients[rec.endpoint]
            try:
                return op(client)
            except WireError as e:
                wire_failures += 1
                if wire_failures >= 2 or not e.retryable:
                    # a protocol error (version skew) is not evidence the
                    # HOST is dead — don't let it trigger a migration
                    raise
                self._host_failed(rec.endpoint, cause=e)
            except ServeError as e:
                if e.reason == "tenant_migrated" or (
                    e.reason == "unknown_tenant"
                    and tenant_id in self._tenants
                ):
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(sleep_s)
                    sleep_s = min(sleep_s * 2, 0.5)
                    continue
                raise

    def submit(self, tenant_id: str, *args: Any, **kw: Any) -> bool:
        """Deliver one batch; a split tenant fans out by stable hash.

        For an unsplit tenant this is :meth:`_submit_one` directly. For a
        split tenant, a monotone per-tenant ordinal is hashed to pick the
        replica, so the fan-out is deterministic given arrival order and
        any retry of THIS batch stays on the replica that booked its seq
        (exactly-once holds per replica namespace)."""
        if _chaos.router_armed():
            _chaos.on_router_op("submit", tenant_id)
        rec = self._routed(tenant_id)
        with self._lock:
            replicas = list(rec.replicas) if rec.replicas else None
            if replicas:
                ordinal = rec.split_next
                rec.split_next = ordinal + 1
        if not replicas:
            return self._submit_one(tenant_id, *args, **kw)
        digest = hashlib.sha256(f"{tenant_id}#{ordinal}".encode()).digest()
        target = replicas[int.from_bytes(digest[:8], "big") % len(replicas)]
        return self._submit_one(target, *args, **kw)

    def _submit_one(self, tenant_id: str, *args: Any, **kw: Any) -> bool:
        """Deliver one batch, surviving a host death or drain mid-submit.

        A transport-failed submit whose batch was already booked in the
        client replay buffer is delivered BY the migration's replay —
        resubmitting it here under a fresh seq would apply it twice, so
        failover only resubmits when the failure struck before booking.
        Three structured rejects mean "the placement is changing, the
        batch was NOT booked; wait and re-route" and are absorbed up to
        ``reroute_grace_s``: ``tenant_migrated`` (a concurrent migration
        exported the client state first), client-side ``unknown_tenant``
        for a tenant the ROUTER still routes (the export-to-adopt window
        of an in-flight migration), and ``draining`` (planned
        decommission; the drain's own migration moves the tenant — a
        drain issued behind the router's back never migrates, so the
        grace period bounds that misuse with a structured error)."""
        wire_failures = 0
        deadline = time.monotonic() + self._reroute_grace_s
        sleep_s = 0.02
        while True:
            rec = self._routed(tenant_id)
            client = self._clients[rec.endpoint]
            try:
                return client.submit(tenant_id, *args, **kw)
            except WireError as e:
                wire_failures += 1
                if wire_failures >= 2 or not e.retryable:
                    raise
                self._host_failed(rec.endpoint, cause=e)
                if getattr(e, "batch_booked", False):
                    # delivery is the migration replay's job — but only a
                    # migration that SUCCEEDED for this tenant (it is
                    # still routed) actually replayed it; a dropped
                    # tenant's batch is gone and saying True would lie
                    with self._lock:
                        still_routed = tenant_id in self._tenants
                    if still_routed:
                        return True
                    raise ServeError(
                        "migration_failed",
                        f"tenant {tenant_id!r} could not be migrated off "
                        f"{rec.endpoint}; the in-flight batch was lost "
                        "with it.",
                    ) from e
            except ServeError as e:
                if getattr(e, "batch_booked", False):
                    # the batch sits in the replay buffer under its seq
                    # (an earlier ambiguous attempt may have been
                    # admitted): it must be delivered by a MIGRATION'S
                    # replay, never resubmitted fresh. Wait for the
                    # tenant to move off this endpoint within the grace
                    # budget; if nothing moves it, surface the error
                    # (the booking stays, a later migration still
                    # delivers exactly once).
                    old_ep = rec.endpoint
                    while time.monotonic() < deadline:
                        self._wait_not_migrating(old_ep, timeout_s=1.0)
                        with self._lock:
                            cur = self._tenants.get(tenant_id)
                        if cur is None:
                            raise ServeError(
                                "migration_failed",
                                f"tenant {tenant_id!r} was dropped while "
                                "its in-flight batch awaited migration.",
                            ) from e
                        if cur.endpoint != old_ep:
                            return True  # migrated: the replay carried it
                        time.sleep(sleep_s)
                        sleep_s = min(sleep_s * 2, 0.5)
                    raise
                if e.reason == "tenant_migrated" or (
                    e.reason == "unknown_tenant"
                    and tenant_id in self._tenants
                ):
                    pass  # re-route (possibly after the wait below)
                elif e.reason == "draining":
                    self._wait_not_migrating(rec.endpoint, timeout_s=5.0)
                else:
                    raise
                if time.monotonic() >= deadline:
                    raise ServeError(
                        "reroute_storm",
                        f"tenant {tenant_id!r}: submit could not settle "
                        f"on a host within {self._reroute_grace_s}s of "
                        "migrations/drains.",
                    ) from e
                time.sleep(sleep_s)
                sleep_s = min(sleep_s * 2, 0.5)

    def compute(self, tenant_id: str, **kw: Any) -> Any:
        rec = self._routed(tenant_id)
        if rec.replicas:
            return self._merged_compute(tenant_id, rec, **kw)
        return self._with_failover(
            tenant_id, lambda c: c.compute(tenant_id, **kw)
        )

    def sync_compute(self, tenant_id: str, **kw: Any) -> Any:
        rec = self._routed(tenant_id)
        if rec.replicas:
            raise ServeError(
                "split_tenant",
                f"tenant {tenant_id!r} is split across "
                f"{len(rec.replicas)} replicas; sync_compute cannot run a "
                "collective barrier across replica streams — use "
                "compute(), which merges replica state.",
            )
        return self._with_failover(
            tenant_id, lambda c: c.sync_compute(tenant_id, **kw)
        )

    def flush(self, tenant_id: str, **kw: Any) -> dict:
        rec = self._routed(tenant_id)
        if rec.replicas:
            return {
                rid: self._with_failover(
                    rid, lambda c, rid=rid: c.flush(rid, **kw)
                )
                for rid in list(rec.replicas)
            }
        return self._with_failover(
            tenant_id, lambda c: c.flush(tenant_id, **kw)
        )

    def detach(self, tenant_id: str, **kw: Any) -> Optional[str]:
        rec = self._routed(tenant_id)
        if rec.replicas:
            result: Optional[str] = None
            for rid in list(rec.replicas):
                try:
                    out = self._with_failover(
                        rid, lambda c, rid=rid: c.detach(rid, **kw)
                    )
                finally:
                    with self._lock:
                        self._tenants.pop(rid, None)
                    self._journal_append("remove", tenant=rid)
                if rid == tenant_id:
                    result = out
            return result
        try:
            return self._with_failover(
                tenant_id, lambda c: c.detach(tenant_id, **kw)
            )
        finally:
            with self._lock:
                self._tenants.pop(tenant_id, None)
            self._journal_append("remove", tenant=tenant_id)

    # ------------------------------------------------------ tenant splitting
    def split_tenant(self, tenant_id: str, replicas: int = 2) -> Dict[str, str]:
        """Shard a hot tenant's stream across ``replicas`` replica tenants.

        The existing stream keeps running as replica 0 under its original
        id (nothing already booked moves); replicas 1..n-1 attach as
        first-class routed tenants ``{tid}@r{k}`` with the same
        spec/knobs, preferring hosts the tenant does not already occupy.
        From the next :meth:`submit` on, batches fan out by stable hash;
        each replica owns its own seq namespace, so exactly-once (dedup,
        replay, migration) holds PER REPLICA. :meth:`compute` merges the
        replica states back into one result (``merge_collections`` for
        sliced tenants, per-member ``merge_state`` otherwise) —
        bit-identical to the single-stream fold. Atomic: a mid-split
        attach failure detaches the replicas already created and leaves
        the tenant unsplit. Returns ``{replica_id: endpoint}``."""
        if not isinstance(replicas, int) or isinstance(replicas, bool) \
                or replicas < 2:
            raise ValueError(
                f"asked for replicas={replicas!r}; a split needs an int "
                ">= 2 (1 replica is just the unsplit tenant)."
            )
        rec = self._routed(tenant_id)
        if rec.parent is not None:
            raise ServeError(
                "split_tenant",
                f"tenant {tenant_id!r} is already a replica of "
                f"{rec.parent!r}; split the parent instead.",
            )
        if rec.replicas:
            raise ServeError(
                "split_tenant",
                f"tenant {tenant_id!r} is already split into "
                f"{len(rec.replicas)} replicas.",
            )
        # replicas must start from a clean seq namespace of their own —
        # a "resume" knob would try to adopt the PARENT's checkpoint
        child_knobs = {
            k: v for k, v in rec.knobs.items() if k != "resume"
        }
        placed: Dict[str, str] = {tenant_id: rec.endpoint}
        created: List[str] = []
        try:
            for k in range(1, replicas):
                rid = _replica_id(tenant_id, k)
                with self._lock:
                    if rid in self._tenants:
                        raise ServeError(
                            "duplicate_tenant",
                            f"replica id {rid!r} is already routed.",
                        )
                try:
                    ep = self._attach_anywhere(
                        rid, rec.spec, child_knobs,
                        exclude=frozenset(placed.values()),
                    )
                except ServeError as e:
                    if e.reason != "no_hosts":
                        raise
                    # fewer hosts than replicas: spreading is best-effort,
                    # the split itself must not require fleet growth
                    ep = self._attach_anywhere(rid, rec.spec, child_knobs)
                with self._lock:
                    self._tenants[rid] = _RoutedTenant(
                        rec.spec, dict(child_knobs), ep, parent=tenant_id
                    )
                # a replica place record WITHOUT a later split record is
                # how recovery identifies (and rolls back) a torn split
                self._journal_append(
                    "place",
                    tenant=rid,
                    endpoint=ep,
                    spec=rec.spec,
                    knobs=dict(child_knobs),
                    parent=tenant_id,
                )
                placed[rid] = ep
                created.append(rid)
        except BaseException:
            for rid in created:
                try:
                    self.detach(rid)
                except (ServeError, WireError):
                    _logger.warning(
                        "router: could not roll back replica %r after a "
                        "failed split of %r", rid, tenant_id,
                    )
            raise
        with self._lock:
            rec.replicas = [
                _replica_id(tenant_id, k) for k in range(replicas)
            ]
            rec.split_next = 0
        # the split's commit record: from here recovery reconstructs the
        # fan-out set (the ordinal itself is reconciliation-derived)
        self._journal_append(
            "split", tenant=tenant_id, replicas=list(rec.replicas)
        )
        if _obs._enabled:
            _obs.counter("serve.router.splits", tenant=tenant_id)
            _trace.instant(
                "serve.router.split",
                kind="router",
                tenant=tenant_id,
                replicas=replicas,
            )
        _logger.info(
            "router: split tenant %r into %d replicas: %s",
            tenant_id, replicas, placed,
        )
        return placed

    def _merged_compute(
        self, tenant_id: str, rec: _RoutedTenant, **kw: Any
    ) -> Any:
        """Compute a split tenant: flush every replica to its durable
        checkpoint, rebuild one collection per replica from the recorded
        spec/knobs, restore, and fold replicas 1..n-1 into replica 0 —
        ``merge_collections`` re-keys cohorts by original id for sliced
        tenants; plain collections merge member-by-member. The result is
        bit-identical to computing the same batches on one stream. The
        rebuilt collections and the merge live on the router's
        ``device``."""
        from torcheval_tpu_torch.metrics import SlicedMetricCollection
        from torcheval_tpu_torch.resilience.snapshot import restore
        from torcheval_tpu_torch.serve.daemon import EvalDaemon
        from torcheval_tpu_torch.serve.wire import build_metrics

        paths: Dict[str, str] = {}
        for rid in list(rec.replicas):
            out = self._with_failover(
                rid, lambda c, rid=rid: c.flush(rid, **kw)
            )
            path = (out or {}).get("path")
            if not path:
                raise ServeError(
                    "no_checkpoint",
                    f"replica {rid!r} of split tenant {tenant_id!r} has "
                    "no durable checkpoint to merge (its host serves "
                    "without a checkpoint directory?).",
                )
            paths[rid] = path
        knobs = rec.knobs
        rebuilt = []
        for rid in list(rec.replicas):
            collection = EvalDaemon.build_collection(
                build_metrics(rec.spec, device=self._device),
                slices=knobs.get("slices"),
                approx=knobs.get("approx"),
                window_chunks=knobs.get("window_chunks"),
            )
            rebuilt.append(restore(collection, paths[rid]))
        base, others = rebuilt[0], rebuilt[1:]
        if isinstance(base, SlicedMetricCollection):
            base.merge_collections(others)
        else:
            for name, member in base.metrics.items():
                member.merge_state([o.metrics[name] for o in others])
        return base.compute()

    # --------------------------------------------------------------- health
    def health(
        self, *, migrate: bool = True, timeout_s: Any = None
    ) -> Dict[str, Any]:
        """Probe every alive host's ``daemon.health()``. A failed probe
        counts ``serve.router.probe_failures{endpoint=}`` and (with
        ``migrate=True``) marks the host dead and migrates its tenants
        right away — a monitoring loop doubles as the failure detector.
        Probes run single-attempt under ``probe_timeout_s`` (overridable
        via ``timeout_s``): one partitioned host must not blind the
        detector to the others for a whole retry ladder. Returns per-host
        health (``None`` for failed probes), the alive set, and the
        tenant placement."""
        probe_timeout = (
            timeout_s if timeout_s is not None else self._probe_timeout_s
        )
        hosts: Dict[str, Any] = {}
        for ep in self.alive:
            try:
                hosts[ep] = self._clients[ep].health(
                    timeout_s=probe_timeout, attempts=1
                )
            except (WireError, ServeError) as e:
                hosts[ep] = None
                if _obs._enabled:
                    _obs.counter(
                        "serve.router.probe_failures", endpoint=ep
                    )
                _logger.warning(
                    "router: health probe of %s failed: %s", ep, e
                )
                if migrate:
                    self._host_failed(ep, cause=e)
        return {
            "hosts": hosts,
            "alive": self.alive,
            "tenants": self.placement(),
        }

    # ------------------------------------------------------ fleet telemetry
    def subscribe_obs(
        self,
        interval_s: float = 1.0,
        *,
        stale_after_s: Optional[float] = None,
        max_events: int = 4096,
    ) -> Dict[str, str]:
        """Open one obs push stream per alive host and fold
        what arrives into the router's fleet view.

        Each host streams O(changed) registry deltas + timeline events +
        its structured ``load_report`` on its own timer; an old host that
        rejects the op degrades to ``health()`` polling on the same
        cadence (``mode == "poll"``). ``stale_after_s`` (default three
        push intervals) is the staleness horizon :meth:`fleet_status`
        marks hosts against. Returns ``{endpoint: mode}``. Idempotent:
        re-subscribing first drops the existing streams."""
        from torcheval_tpu_torch.metrics.toolkit import _check_timeout_s

        _check_timeout_s(interval_s)
        if stale_after_s is None:
            stale_after_s = 3.0 * float(interval_s)
        _check_timeout_s(stale_after_s)
        if max_events < 0:
            raise ValueError(f"max_events must be >= 0, got {max_events}.")
        self.unsubscribe_obs()
        with self._fleet_lock:
            self._obs_interval_s = float(interval_s)
            self._stale_after_s = float(stale_after_s)
            self._fleet_max_events = int(max_events)
        modes: Dict[str, str] = {}
        for ep in self.alive:
            try:
                sub = self._clients[ep].subscribe_obs(
                    interval_s,
                    on_push=lambda msg, _ep=ep: self._on_obs_push(_ep, msg),
                )
            except (WireError, ServeError) as e:
                _logger.warning(
                    "router: obs subscription to %s failed: %s", ep, e
                )
                continue
            with self._fleet_lock:
                self._obs_subs[ep] = sub
            modes[ep] = sub.mode
        return modes

    def unsubscribe_obs(self) -> None:
        """Stop every obs stream (folded fleet state is kept)."""
        with self._fleet_lock:
            subs, self._obs_subs = self._obs_subs, {}
        for sub in subs.values():
            sub.stop()

    def _on_obs_push(self, endpoint: str, msg: Dict[str, Any]) -> None:
        """Fold one pushed (or polled) obs message into the fleet view.
        Runs on the subscription's thread — only ``_fleet_lock`` here."""
        from torcheval_tpu_torch.obs.stream import DeltaAccumulator

        with self._fleet_lock:
            rec = self._fleet.get(endpoint)
            if rec is None:
                rec = {
                    "acc": DeltaAccumulator(),
                    "events": [],
                    "events_trimmed": 0,
                    "report": None,
                    "received_at": 0.0,
                    "mode": "poll",
                    "pushes": 0,
                }
                self._fleet[endpoint] = rec
            rec["mode"] = (
                "push" if msg.get("op") == "obs_push" else "poll"
            )
            rec["received_at"] = time.monotonic()
            rec["pushes"] += 1
            if msg.get("load_report") is not None:
                rec["report"] = msg["load_report"]
            delta = msg.get("delta")
            if delta:
                rec["acc"].apply(delta)
                events = delta.get("events") or ()
                if events:
                    rec["events"].extend(events)
                    overflow = (
                        len(rec["events"]) - self._fleet_max_events
                    )
                    if overflow > 0:
                        del rec["events"][:overflow]
                        rec["events_trimmed"] += overflow
                rec["events_trimmed"] += int(
                    delta.get("events_trimmed", 0)
                )

    def fleet_status(
        self, *, stale_after_s: Optional[float] = None
    ) -> Dict[str, Any]:
        """The folded fleet view: per-host latest ``load_report``, push
        age, and a ``stale`` flag (no load report yet, or the last one is
        older than ``stale_after_s``). A killed host goes stale here
        within one horizon — BEFORE a health probe or tenant op marks it
        dead — which is the point: the stream is the early-warning
        channel, the failure detector stays authoritative for eviction.
        Pure local fold; no network, no collective rounds."""
        if stale_after_s is None:
            stale_after_s = self._stale_after_s
        if stale_after_s is None:
            stale_after_s = 3.0  # fleet view without an active stream
        now = time.monotonic()
        alive = set(self.alive)
        hosts: Dict[str, Any] = {}
        fresh_loads: List[float] = []
        with self._fleet_lock:
            endpoints = set(self._fleet) | set(self._obs_subs)
            for ep in sorted(endpoints | alive):
                rec = self._fleet.get(ep)
                sub = self._obs_subs.get(ep)
                age = (
                    now - rec["received_at"]
                    if rec is not None and rec["received_at"]
                    else None
                )
                report = rec["report"] if rec else None
                load = self._host_load(report) if report else None
                stale = age is None or age > stale_after_s
                hosts[ep] = {
                    "alive": ep in alive,
                    "mode": rec["mode"] if rec else (
                        sub.mode if sub is not None else None
                    ),
                    "subscribed": sub is not None,
                    "age_s": age,
                    "stale": stale,
                    "load_report": report,
                    "load": load,
                    "pushes": rec["pushes"] if rec else 0,
                }
                if (
                    ep in alive
                    and not stale
                    and load is not None
                    and not (report or {}).get("draining")
                ):
                    fresh_loads.append(load)
        # aggregate spare capacity across hosts with a FRESH report:
        # 1.0 = idle fleet, 0.0 = every reporting host saturated, None =
        # nobody is reporting (a policy must not scale on silence)
        headroom = (
            1.0 - sum(fresh_loads) / len(fresh_loads)
            if fresh_loads
            else None
        )
        if _obs._enabled and headroom is not None:
            _obs.gauge("serve.fleet.headroom", float(headroom))
        return {
            "schema": 1,
            "hosts": hosts,
            "alive": sorted(alive),
            "tenants": self.placement(),
            "stale_after_s": float(stale_after_s),
            "headroom": headroom,
        }

    def fleet_snapshot(self, endpoint: str) -> Dict[str, Any]:
        """The accumulated registry snapshot for one host (exact fold of
        every delta received so far, ``Registry.snapshot()`` shape)."""
        with self._fleet_lock:
            rec = self._fleet.get(endpoint)
            if rec is None:
                raise ValueError(
                    f"no obs stream state for endpoint {endpoint!r}."
                )
            return rec["acc"].snapshot()

    def fleet_chrome_trace(self, **json_kwargs: Any) -> str:
        """One Chrome/Perfetto trace for the whole fleet: every host's
        pushed timeline events merged into the router's own timeline via
        ``obs.chrome_trace(extra_events=)``, with ``pid`` = the host
        endpoint — each host renders as its own process row, tenant spans
        nested under it. Open in ``chrome://tracing`` / Perfetto."""
        from torcheval_tpu_torch.obs import chrome_trace

        extra: List[Dict[str, Any]] = []
        with self._fleet_lock:
            for ep, rec in self._fleet.items():
                for e in rec["events"]:
                    tagged = dict(e)
                    tagged["rank"] = ep  # pid=host in the merged trace
                    extra.append(tagged)
        return chrome_trace(extra_events=extra, **json_kwargs)

    # ------------------------------------------------------------ migration
    def _wait_not_migrating(
        self, endpoint: str, *, timeout_s: float = 300.0
    ) -> None:
        """Block until no migration is in flight for ``endpoint`` (or the
        bound expires), so a caller that returns afterwards observes
        post-migration routing."""
        with self._cv:
            self._cv.wait_for(
                lambda: endpoint not in self._migrating, timeout=timeout_s
            )

    def _host_failed(self, endpoint: str, *, cause: BaseException) -> None:
        """Mark ``endpoint`` dead and migrate every tenant it held.
        Single-flight per endpoint: exactly one thread runs the
        migration; concurrent reporters of the same failure WAIT for it
        (their booked batches are delivered by the migration's replay,
        so returning before it finishes would lie to them). The network
        work runs OUTSIDE the router lock — healthy hosts keep serving
        while a dead one is migrated."""
        with self._cv:
            if endpoint in self._alive:
                self._alive.discard(endpoint)
                self._migrating.add(endpoint)
            elif endpoint in self._migrating:
                self._cv.wait_for(
                    lambda: endpoint not in self._migrating, timeout=300.0
                )
                return
            else:
                return  # already dead and fully migrated
        _logger.warning(
            "router: endpoint %s marked dead (%s); migrating its tenants.",
            endpoint,
            cause,
        )
        try:
            self._migrate_host(endpoint, reason="host_failure")
        finally:
            with self._cv:
                self._migrating.discard(endpoint)
                self._cv.notify_all()

    def drain(
        self, endpoint: str, *, timeout_s: Any = None
    ) -> Dict[str, Any]:
        """Gracefully move every tenant off ``endpoint``: the host
        checkpoints-and-evicts them all (admissions stop immediately),
        the endpoint leaves the alive set, and the tenants re-attach
        elsewhere from their fresh checkpoints. Returns
        ``{"drained": {tenant: ckpt_path}, "migrated": [tenant, ...]}``."""
        if endpoint not in self._clients:
            raise ValueError(f"unknown endpoint {endpoint!r}.")
        kw = {} if timeout_s is None else {"timeout_s": timeout_s}
        drained = self._clients[endpoint].drain(**kw)
        with self._lock:
            self._drained.add(endpoint)
        # recorded as intent: unlike a death (probes re-derive those), a
        # drain must survive recovery — the host answers probes but must
        # stay out of the alive set
        self._journal_append("host_drain", endpoint=endpoint)
        with self._cv:
            if endpoint in self._migrating:
                # a concurrent failure migration beat us to the move;
                # wait it out — the drain still checkpointed everything
                self._cv.wait_for(
                    lambda: endpoint not in self._migrating, timeout=300.0
                )
                return {"drained": drained, "migrated": []}
            self._alive.discard(endpoint)
            self._migrating.add(endpoint)
        try:
            migrated = self._migrate_host(endpoint, reason="drain")
        finally:
            with self._cv:
                self._migrating.discard(endpoint)
                self._cv.notify_all()
        return {"drained": drained, "migrated": migrated}

    def _migrate_host(self, endpoint: str, *, reason: str) -> List[str]:
        """Move every tenant routed to ``endpoint`` onto survivors.
        Caller holds the endpoint's ``_migrating`` slot (single-flight),
        NOT the router lock — the per-tenant network work must not stall
        ops against healthy hosts."""
        with self._lock:
            victims = [
                t
                for t, rec in self._tenants.items()
                if rec.endpoint == endpoint
            ]
        migrated: List[str] = []
        with _obs.span(
            "serve.router.migrate", endpoint=endpoint, reason=reason
        ):
            for tenant_id in victims:
                try:
                    self._migrate_tenant(tenant_id, endpoint, reason)
                    migrated.append(tenant_id)
                except Exception as e:  # noqa: BLE001 - containment wall
                    # a tenant that cannot migrate (no usable checkpoint —
                    # incl. a remote CheckpointError — no survivors, a
                    # checkpoint_behind refusal) is dropped from the
                    # routing table with a loud log, and the REST of the
                    # host's tenants still migrate: one tenant's bad
                    # checkpoint must never strand its neighbors on a
                    # dead endpoint. The caller's next op on the dropped
                    # tenant raises unknown_tenant, never a silent ghost.
                    _logger.error(
                        "router: tenant %r failed to migrate off %s: %s",
                        tenant_id,
                        endpoint,
                        e,
                    )
                    with self._lock:
                        self._tenants.pop(tenant_id, None)
                    self._journal_append("remove", tenant=tenant_id)
        if _obs._enabled and victims:
            _trace.instant(
                "serve.router.migrated",
                kind="serve",
                endpoint=endpoint,
                reason=reason,
                tenants=len(migrated),
            )
        return migrated

    def _migrate_tenant(
        self, tenant_id: str, from_ep: str, reason: str
    ) -> None:
        with self._lock:
            rec = self._tenants.get(tenant_id)
        if rec is None:
            return  # detached while the migration was queued
        exported = self._clients[from_ep].export_tenant(tenant_id)
        if _chaos.router_armed():
            # the drill's nastiest window: the wire state is exported,
            # the tenant is adopted nowhere — recovery must re-derive
            # everything from the journal + the hosts
            _chaos.on_router_op("migrate_exported", tenant_id)
        new_ep = self._place(tenant_id)
        client = self._clients[new_ep]
        knobs = dict(rec.knobs)
        knobs["resume"] = "auto"  # restore the shared-root checkpoint
        attach_resp = client.attach(tenant_id, rec.spec, **knobs)
        replayed = client.adopt_tenant(
            tenant_id, exported, restored_seq=int(attach_resp["last_seq"])
        )
        with self._lock:
            rec.endpoint = new_ep
            rec.placed_at = time.monotonic()  # restart the dwell clock
        self._journal_append("move", tenant=tenant_id, endpoint=new_ep)
        if _obs._enabled:
            _obs.counter("serve.router.migrations", reason=reason)
        _logger.warning(
            "router: migrated tenant %r %s -> %s (%s; checkpoint seq %d, "
            "replayed %d)",
            tenant_id,
            from_ep,
            new_ep,
            reason,
            int(attach_resp["last_seq"]),
            replayed,
        )

    # ------------------------------------------------------------ rebalance
    def rebalance(
        self,
        *,
        hot_load: float = 0.75,
        improvement: float = 0.15,
        min_dwell_s: float = 10.0,
        max_moves: int = 1,
    ) -> List[str]:
        """One load-rebalancing pass: move tenants off hot hosts onto
        the coldest eligible ones using the LIVE-host migration protocol
        (flush -> export -> drop -> re-attach -> adopt; the replay tail
        makes the move exactly-once even for batches booked mid-failure).

        Thrash-proof by construction, not by tuning: a host is hot only
        at fresh ``load >= hot_load``; a move happens only onto a target
        at least ``improvement`` colder than the source (so a move can
        never create a hotter imbalance than it cured); a tenant moves at
        most once per ``min_dwell_s`` (the dwell clock resets on every
        placement); and one pass moves at most ``max_moves`` tenants.
        Returns the moved tenant ids."""
        if max_moves < 1:
            raise ValueError(f"max_moves must be >= 1, got {max_moves}.")
        info = self._fleet_loads()
        with self._cv:
            migrating = set(self._migrating)
        loads = {
            ep: d["load"]
            for ep, d in info.items()
            if d["load"] is not None and ep not in migrating
        }
        hot = sorted(
            (
                ep
                for ep, load in loads.items()
                if load >= hot_load and not info[ep]["draining"]
            ),
            key=lambda ep: -loads[ep],
        )
        moved: List[str] = []
        if not hot:
            return moved
        now = time.monotonic()
        for src_ep in hot:
            if len(moved) >= max_moves:
                break
            targets = sorted(
                (
                    ep
                    for ep, load in loads.items()
                    if ep != src_ep
                    and not info[ep]["draining"]
                    and not info[ep]["suspect"]
                    and loads[src_ep] - load >= improvement
                ),
                key=lambda ep: loads[ep],
            )
            if not targets:
                continue
            with self._lock:
                candidates = [
                    t
                    for t, rec in self._tenants.items()
                    if rec.endpoint == src_ep
                    and now - rec.placed_at >= min_dwell_s
                ]
            for tenant_id in candidates:
                if len(moved) >= max_moves:
                    break
                if self._rebalance_move(tenant_id, src_ep, targets[0]):
                    moved.append(tenant_id)
        if moved:
            _logger.info(
                "router: rebalance moved %d tenant(s): %s", len(moved),
                moved,
            )
        return moved

    def _rebalance_move(
        self, tenant_id: str, from_ep: str, to_ep: str
    ) -> bool:
        """Move one LIVE tenant ``from_ep -> to_ep``. Unlike the failure
        path, the source is healthy: flush first (durable resume point),
        export the client wire state (racing submits start absorbing into
        the reroute grace window here), release the source slot WITHOUT a
        second checkpoint (the flush already published the resume
        source), then attach-resume + adopt on the target — the adopt
        replays only the booked-but-not-durable tail, so exactly-once
        holds across the move. If the chosen target refuses, the tenant
        falls back onto the source; a tenant that can be placed nowhere
        is dropped from the routing table with a loud log (the same
        containment wall as failure migration). Returns True if the
        tenant moved."""
        with self._lock:
            rec = self._tenants.get(tenant_id)
        if rec is None or rec.endpoint != from_ep:
            return False  # detached or moved underneath us
        src = self._clients[from_ep]
        knobs = dict(rec.knobs)
        knobs["resume"] = "auto"  # restore the shared-root checkpoint
        with _obs.span(
            "serve.router.migrate", endpoint=from_ep, reason="rebalance"
        ):
            try:
                src.flush(tenant_id)
                exported = src.export_tenant(tenant_id)
            except (ServeError, WireError) as e:
                # the source refused the hand-off: nothing moved, the
                # tenant still serves where it was — just skip this pass
                _logger.warning(
                    "router: rebalance of %r could not export from %s: "
                    "%s", tenant_id, from_ep, e,
                )
                return False
            if _chaos.router_armed():
                _chaos.on_router_op("migrate_exported", tenant_id)
            try:
                src.drop_tenant(tenant_id, checkpoint=False)
            except (ServeError, WireError) as e:
                _logger.warning(
                    "router: rebalance of %r: source %s did not release "
                    "its slot cleanly: %s", tenant_id, from_ep, e,
                )
            replayed = None
            for target in (to_ep, from_ep):
                try:
                    resp = self._clients[target].attach(
                        tenant_id, rec.spec, **knobs
                    )
                    replayed = self._clients[target].adopt_tenant(
                        tenant_id,
                        exported,
                        restored_seq=int(resp["last_seq"]),
                    )
                    new_ep = target
                    break
                except (ServeError, WireError) as e:
                    _logger.warning(
                        "router: rebalance target %s refused tenant %r: "
                        "%s", target, tenant_id, e,
                    )
            if replayed is None:
                _logger.error(
                    "router: tenant %r could not be re-placed after a "
                    "rebalance export off %s; dropping it from the "
                    "routing table.", tenant_id, from_ep,
                )
                with self._lock:
                    self._tenants.pop(tenant_id, None)
                self._journal_append("remove", tenant=tenant_id)
                return False
        with self._lock:
            rec.endpoint = new_ep
            rec.placed_at = time.monotonic()
        self._journal_append("move", tenant=tenant_id, endpoint=new_ep)
        if _obs._enabled:
            _obs.counter("serve.router.migrations", reason="rebalance")
            _obs.counter("serve.router.rebalances", endpoint=from_ep)
        if new_ep == from_ep:
            return False  # fell back home: no rebalance happened
        _logger.info(
            "router: rebalanced tenant %r %s -> %s (replayed %d)",
            tenant_id, from_ep, new_ep, replayed,
        )
        return True

    def start_rebalancer(
        self, interval_s: float = 2.0, **rebalance_kw: Any
    ) -> None:
        """Run :meth:`rebalance` on a background timer until
        :meth:`stop_rebalancer` / :meth:`close`. ``rebalance_kw`` are
        passed through to every pass (hysteresis knobs). Idempotent:
        restarting replaces the running timer."""
        from torcheval_tpu_torch.metrics.toolkit import _check_timeout_s

        _check_timeout_s(interval_s)
        self.stop_rebalancer()
        stop = threading.Event()

        def _loop() -> None:
            while not stop.wait(interval_s):
                try:
                    self.rebalance(**rebalance_kw)
                except Exception:  # noqa: BLE001 - keep the timer alive
                    _logger.exception("router: rebalance pass failed")

        thread = threading.Thread(
            target=_loop,
            name="torcheval-tpu-router-rebalance",
            daemon=True,
        )
        self._rebalance_stop = stop
        self._rebalance_thread = thread
        thread.start()

    def stop_rebalancer(self) -> None:
        thread = self._rebalance_thread
        if thread is None:
            return
        self._rebalance_stop.set()
        thread.join(timeout=10.0)
        self._rebalance_thread = None

    # ------------------------------------------------------------- elasticity
    def add_host(self, endpoint: str) -> None:
        """Join one serving endpoint at runtime (scale-up). The router
        mints a client with the same factory/kwargs the constructor used,
        joins the host into the active obs stream (when one is running),
        and the very next placement can choose it — already-routed
        tenants move only via :meth:`rebalance` / failure migration, so
        joining is disruption-free. Re-adding an endpoint that died is
        allowed once its failure migration finished; re-adding a live one
        raises ``ValueError``."""
        self._wait_not_migrating(endpoint)
        client = self._client_factory(endpoint, **self._client_kwargs)
        endpoint = client.endpoint  # normalized form
        with self._cv:
            if endpoint in self._alive:
                client.close()
                raise ValueError(
                    f"endpoint {endpoint!r} is already in the fleet."
                )
            stale = self._clients.pop(endpoint, None)
            self._clients[endpoint] = client
            self._alive.add(endpoint)
            self._drained.discard(endpoint)
        self._journal_append("host_add", endpoint=endpoint)
        if stale is not None:
            stale.close()
        with self._fleet_lock:
            # a fresh process behind a recycled endpoint must not inherit
            # the dead one's folded telemetry
            self._fleet.pop(endpoint, None)
            interval_s = self._obs_interval_s
        if interval_s is not None:
            try:
                sub = client.subscribe_obs(
                    interval_s,
                    on_push=lambda msg, _ep=endpoint: self._on_obs_push(
                        _ep, msg
                    ),
                )
            except (WireError, ServeError) as e:
                _logger.warning(
                    "router: obs subscription to %s failed: %s",
                    endpoint, e,
                )
            else:
                with self._fleet_lock:
                    self._obs_subs[endpoint] = sub
        if _obs._enabled:
            _trace.instant(
                "serve.router.host_added", kind="router", endpoint=endpoint
            )
        _logger.info("router: endpoint %s joined the fleet.", endpoint)

    def remove_host(self, endpoint: str) -> Dict[str, Any]:
        """Decommission one endpoint (scale-down): stop its obs stream,
        :meth:`drain` it (checkpoint-and-evict everything, migrate the
        tenants onto survivors), then forget it entirely — unlike a
        drained host, a removed one is no longer probed or re-placeable.
        A host that is already dead is migrated-and-forgotten instead of
        drained. Returns the drain result."""
        if endpoint not in self._clients:
            raise ValueError(f"unknown endpoint {endpoint!r}.")
        with self._fleet_lock:
            sub = self._obs_subs.pop(endpoint, None)
        if sub is not None:
            sub.stop()
        try:
            out = self.drain(endpoint)
        except WireError as e:
            self._host_failed(endpoint, cause=e)
            out = {"drained": {}, "migrated": []}
        with self._cv:
            self._alive.discard(endpoint)
            self._drained.discard(endpoint)
            client = self._clients.pop(endpoint, None)
        self._journal_append("host_remove", endpoint=endpoint)
        with self._fleet_lock:
            self._fleet.pop(endpoint, None)
        if client is not None:
            client.close()
        if _obs._enabled:
            _trace.instant(
                "serve.router.host_removed",
                kind="router",
                endpoint=endpoint,
            )
        _logger.info("router: endpoint %s left the fleet.", endpoint)
        return out

    def autoscale_step(
        self,
        policy: "ScalingPolicy",
        *,
        provision: Any = None,
        decommission: Any = None,
    ) -> int:
        """Run one autoscaling decision: feed :meth:`fleet_status` to
        ``policy.decide`` and act on the signed host delta —
        ``provision()`` must return a NEW ready endpoint for each
        scale-up step (it is the deployer's hook: start the process, then
        tell the router); each scale-down step picks the coldest host,
        :meth:`remove_host`\\ s it, then hands the endpoint to
        ``decommission(endpoint)`` for teardown. A direction whose hook
        is missing is a no-op (the decision is still returned, so a
        caller can act out-of-band). Returns the policy's delta."""
        delta = int(policy.decide(self.fleet_status()))
        if delta > 0 and provision is not None:
            for _ in range(delta):
                self.add_host(provision())
        elif delta < 0 and decommission is not None:
            for _ in range(-delta):
                alive = self.alive
                if len(alive) <= 1:
                    break  # never scale to an empty fleet
                info = self._fleet_loads()
                coldest = min(
                    alive,
                    key=lambda ep: info.get(ep, {}).get("load") or 0.0,
                )
                self.remove_host(coldest)
                decommission(coldest)
        return delta


class ScalingPolicy:
    """Decide fleet resizing from one :meth:`EvalRouter.fleet_status`
    snapshot. ``decide`` returns a signed host delta: positive = add
    that many hosts, negative = drain-and-remove, 0 = hold. Policies are
    pure deciders — :meth:`EvalRouter.autoscale_step` owns the acting."""

    def decide(self, fleet_status: Dict[str, Any]) -> int:
        raise NotImplementedError


class HeadroomScalingPolicy(ScalingPolicy):
    """Scale on aggregate fleet headroom (``fleet_status()["headroom"]``,
    1.0 = idle, 0.0 = saturated): below ``scale_up_below`` asks for one
    more host, above ``scale_down_above`` releases one, inside the band
    holds. ``cooldown_s`` of mandatory quiet follows every nonzero
    decision, and ``min_hosts``/``max_hosts`` bound the fleet — with the
    dead band this makes the policy hysteretic, so load hovering at a
    threshold cannot flap the fleet. ``headroom is None`` (nobody
    reporting) always holds: a policy must not scale on silence."""

    def __init__(
        self,
        *,
        scale_up_below: float = 0.2,
        scale_down_above: float = 0.8,
        min_hosts: int = 1,
        max_hosts: Optional[int] = None,
        cooldown_s: float = 30.0,
    ) -> None:
        if not 0.0 <= scale_up_below < scale_down_above <= 1.0:
            raise ValueError(
                "need 0 <= scale_up_below < scale_down_above <= 1, got "
                f"{scale_up_below!r} / {scale_down_above!r} (the gap is "
                "the hysteresis dead band)."
            )
        if min_hosts < 1:
            raise ValueError(f"min_hosts must be >= 1, got {min_hosts}.")
        if max_hosts is not None and max_hosts < min_hosts:
            raise ValueError(
                f"max_hosts={max_hosts} is below min_hosts={min_hosts}."
            )
        if cooldown_s < 0:
            raise ValueError(
                f"cooldown_s must be >= 0, got {cooldown_s}."
            )
        self.scale_up_below = float(scale_up_below)
        self.scale_down_above = float(scale_down_above)
        self.min_hosts = int(min_hosts)
        self.max_hosts = max_hosts
        self.cooldown_s = float(cooldown_s)
        self._last_scaled_at: Optional[float] = None

    def decide(self, fleet_status: Dict[str, Any]) -> int:
        headroom = fleet_status.get("headroom")
        if headroom is None:
            return 0
        now = time.monotonic()
        if (
            self._last_scaled_at is not None
            and now - self._last_scaled_at < self.cooldown_s
        ):
            return 0
        n_hosts = len(fleet_status.get("alive") or ())
        if headroom < self.scale_up_below and (
            self.max_hosts is None or n_hosts < self.max_hosts
        ):
            self._last_scaled_at = now
            return 1
        if (
            headroom > self.scale_down_above
            and n_hosts > self.min_hosts
        ):
            self._last_scaled_at = now
            return -1
        return 0
