"""An in-process fleet of serving hosts for the router's CPU tests.

JAX counterpart: the ``_ClusterMixin`` / ``_RecoveryMixin`` set-ups of
``tests/serve/test_router*.py``, ``test_elastic.py`` and
``test_split_tenant.py``. Each host is an ``EvalDaemon(device="cpu")`` +
``EvalServer`` sharing one checkpoint root; a "dead" host is a closed
server and a stopped daemon, which drives the same client and router
recovery code a killed process does. Every socket binds port 0.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

NUM_CLASSES = 5
SPEC = {"acc": ["MulticlassAccuracy", {"num_classes": NUM_CLASSES}]}
ROUTER_KW = dict(
    request_timeout_s=10.0, connect_timeout_s=1.0, max_attempts=2, backoff_base_s=0.01
)


def batch(seed: int = 0, n: int = 8):
    """The JAX tests' ``_batch``: seeded (n, 5) scores and labels."""
    rng = np.random.default_rng(seed)
    return rng.random((n, NUM_CLASSES)).astype(np.float32), rng.integers(0, NUM_CLASSES, n)


def oracle(batches) -> float:
    """``MulticlassAccuracy`` over ``batches`` on one stream, on the CPU."""
    from torcheval_tpu_torch.metrics import MulticlassAccuracy

    m = MulticlassAccuracy(num_classes=NUM_CLASSES, device="cpu")
    for s, l in batches:
        m.update(s, l)
    return float(m.compute())


def acc(result) -> float:
    return float(np.asarray(result["acc"]))


def report(p99_s: float = 0.0, draining: bool = False) -> Dict[str, Any]:
    """A minimal schema-1 load report carrying one latency pressure."""
    return {
        "schema": 1,
        "draining": draining,
        "capacity": {"max_tenants": 0, "active_tenants": 0},
        "queue": {"depth": 0, "capacity": 0},
        "latency": {"submit_p99_s": p99_s, "submit_ewma_s": p99_s},
        "hbm": {},
    }


def inject(router, endpoint: str, load_report: Dict[str, Any], *, age_s: float = 0.0) -> None:
    """Plant a folded load report for ``endpoint`` as if the obs stream
    had delivered it ``age_s`` seconds ago (either package's router)."""
    with router._fleet_lock:
        router._fleet[endpoint] = {
            "acc": None,
            "events": [],
            "events_trimmed": 0,
            "report": load_report,
            "received_at": time.monotonic() - age_s,
            "mode": "push",
            "pushes": 1,
        }


def wait(predicate: Callable[[], bool], timeout_s: float = 30.0, interval_s: float = 0.02) -> bool:
    """Poll ``predicate`` until it holds or ``timeout_s`` passes."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


class Fleet:
    """``n`` hosts on one checkpoint root, and the routers made over them;
    :meth:`close` tears everything down (routers first). The last host's
    server is a ``last_server_cls`` where one is given (an old peer)."""

    def __init__(self, root: str, n: int, last_server_cls=None) -> None:
        self.root = root
        self.daemons: List[Any] = []
        self.servers: List[Any] = []
        self.routers: List[Any] = []
        for i in range(n):
            self.start_host(last_server_cls if i == n - 1 else None)

    @property
    def endpoints(self) -> List[str]:
        return [s.endpoint for s in self.servers]

    def start_host(self, server_cls=None) -> str:
        from torcheval_tpu_torch.serve import EvalDaemon, EvalServer

        daemon = EvalDaemon(device="cpu", evict_dir=self.root).start()
        server = (server_cls or EvalServer)(daemon)
        self.daemons.append(daemon)
        self.servers.append(server)
        return server.endpoint

    def router(self, endpoints: Optional[List[str]] = None, **kw):
        from torcheval_tpu_torch.serve import EvalRouter

        merged = dict(ROUTER_KW)
        merged.update(kw)
        merged.setdefault("device", "cpu")
        r = EvalRouter(endpoints or self.endpoints, **merged)
        self.routers.append(r)
        return r

    def kill(self, endpoint: str) -> None:
        i = self.endpoints.index(endpoint)
        self.servers[i].close()
        self.daemons[i].stop()

    def daemon_for(self, endpoint: str):
        return self.daemons[self.endpoints.index(endpoint)]

    def total_dupes(self) -> int:
        total = 0
        for d in self.daemons:
            try:
                tenants = d.health()["tenants"]
            except RuntimeError:  # a host the test killed
                continue
            total += sum(t.get("dupes", 0) for t in tenants.values())
        return total

    def spread(self, router, per_host: int = 3, prefix: str = "t") -> List[str]:
        """Attach tenants chosen so every alive host holds ``per_host`` of
        them (endpoint strings carry ephemeral ports, so fixed names could
        all land on one host): the router's own placement picks them."""
        counts = {ep: 0 for ep in router.alive}
        ids = []
        for i in range(256):
            if min(counts.values()) >= per_host:
                break
            tid = f"{prefix}{i}"
            ep = router._place(tid)
            if counts[ep] >= per_host:
                continue
            router.attach(tid, SPEC)
            counts[ep] += 1
            ids.append(tid)
        assert len(set(router.placement().values())) == len(counts), router.placement()
        return ids

    def close(self) -> None:
        for r in self.routers:
            r.close()
        for server, daemon in zip(self.servers, self.daemons):
            server.close()
            daemon.stop()
