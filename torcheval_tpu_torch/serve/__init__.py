"""``torcheval_tpu_torch.serve``: a fault-contained multi-tenant eval service.

JAX counterpart: ``torcheval_tpu/serve/``. This is its single serving host:
one persistent :class:`EvalDaemon` owns one torch device (``cuda:0``
unless the caller asks for another) and serves many concurrent eval
streams (*tenants*), each backed by a
:class:`~torcheval_tpu_torch.metrics.MetricCollection` —

* **async ingestion** over bounded per-tenant queues with admission
  control and explicit backpressure (:class:`AdmissionError` /
  :class:`BackpressureError`: reject-with-reason, never unbounded growth);
* **batch coalescing** — tenants with identical batch signatures are
  served back-to-back and their queued host batches move to the device in
  one copy per signature group, with a control-first fallback lane so
  coalescing never delays a result;
* **fault containment** — a poisoned batch or a raising compute
  quarantines exactly that tenant (:class:`TenantQuarantinedError`, the
  cause attached) while every other tenant proceeds; an idle tenant's
  watchdog deadline evicts it through an atomic ``resilience.save``
  checkpoint (:class:`TenantEvictedError` carries the path) and a
  re-``attach`` resumes bit-identically;
* **per-tenant observability** — ingest/shed/quarantine/eviction
  counters, queue-depth histograms and per-tenant spans in the port's obs
  registry and Chrome trace, plus ``EvalDaemon.health()`` (local) /
  ``health(sync=True)`` (all ranks, one collective round).

Ingest is a zero-copy, overlapped pipeline (``ingest.py``): frame
payloads land in a pooled, size-classed staging buffer — pinned host
memory for a CUDA daemon — and decode as zero-copy views; each serving
pass moves a whole coalesced signature group to the device in ONE
asynchronous copy on the daemon's copy stream (identical broadcast
batches transfer once), and a staging slot is recycled only after the
CUDA event recorded behind the copy that read it. Eval windows
double-buffer through that stream: window N+1's bytes move while window
N's step runs. The client side coalesces too:
``EvalClient(submit_buffer=K)`` ships K booked batches per
``submit_many`` frame through a scatter-gather packer.

The network layer on top of the same daemon:

* **wire** (``wire.py``) — length-prefixed JSON + npz framing, an
  :class:`EvalServer` TCP front end per daemon, structured errors
  crossing with their ``retryable`` classification intact. The frames are
  the JAX package's byte for byte, so a client of either package drives
  a server of the other;
* **client** (``client.py``) — :class:`EvalClient` with per-request
  deadlines, exponential backoff + jitter, a per-host circuit breaker,
  bounded in-flight, idempotent submits (per-tenant monotonic sequence
  numbers + a bounded replay buffer: at-least-once on the wire,
  exactly-once into the metric state), deferred-ack pipelining, the
  same-process local transport, and an ``obs_push`` telemetry
  subscription (``EvalClient.subscribe_obs``).

The cluster layer on top of the hosts:

* **router** (``router.py``) — :class:`EvalRouter` places tenants by
  weighted rendezvous hashing over the alive endpoints, probes health,
  migrates a dead or drained host's tenants from the shared checkpoint
  root plus the client replay tail, rebalances hot hosts, splits a hot
  tenant across replica tenants (merged on the router's ``device``), and
  grows or shrinks the fleet through a :class:`ScalingPolicy`
  (:class:`HeadroomScalingPolicy`);
* **journal** (``journal.py``) — the router's fsync'd control-plane log
  and snapshot, the JAX format byte for byte, so a restarted router
  replays it and reconciles against the live hosts.
"""

from torcheval_tpu_torch.serve.client import EvalClient, ObsSubscription, metric_spec
from torcheval_tpu_torch.serve.daemon import EvalDaemon
from torcheval_tpu_torch.serve.errors import (
    AdmissionError,
    BackpressureError,
    ServeError,
    TenantError,
    TenantEvictedError,
    TenantQuarantinedError,
    WireError,
)
from torcheval_tpu_torch.serve.router import EvalRouter, HeadroomScalingPolicy, ScalingPolicy
from torcheval_tpu_torch.serve.tenant import TenantHandle, TenantStatus
from torcheval_tpu_torch.serve.wire import EvalServer

__all__ = [
    "AdmissionError",
    "BackpressureError",
    "EvalClient",
    "EvalDaemon",
    "EvalRouter",
    "EvalServer",
    "HeadroomScalingPolicy",
    "ObsSubscription",
    "ScalingPolicy",
    "ServeError",
    "TenantError",
    "TenantEvictedError",
    "TenantHandle",
    "TenantQuarantinedError",
    "TenantStatus",
    "WireError",
    "metric_spec",
]
