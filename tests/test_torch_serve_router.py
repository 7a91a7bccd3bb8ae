"""The port's ``EvalRouter`` on the CPU: placement, probe-driven failure
detection, host-death migration with checkpoint + replay exactness, and
graceful drain; then the router's pure decisions held to the JAX
router's on the same inputs.

Counterpart: ``tests/serve/test_router.py``. The hosts are in-process
``EvalDaemon(device="cpu")`` + ``EvalServer`` pairs on one checkpoint
root (``utils/test_utils/router_fleet.py``); a dead host is a closed
server. The parity half builds both routers over the same endpoint
strings (no server behind them: placement never touches the network)
and compares ``_place`` over 200 tenant ids, ``_host_load`` and
``HeadroomScalingPolicy.decide`` on the same seeded reports, exactly.
"""

import json
import socket
import time

import numpy as np
import pytest
import torch

import torcheval_tpu.serve as jserve
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.serve import EvalRouter, HeadroomScalingPolicy, ServeError
from torcheval_tpu_torch.utils.test_utils import obs_counts
from torcheval_tpu_torch.utils.test_utils.router_fleet import (
    SPEC,
    Fleet,
    acc,
    batch,
    inject,
    oracle,
)


@pytest.fixture
def obs_on():
    obs.reset()
    obs.enable()
    yield
    obs.disable()
    obs.reset()


@pytest.fixture
def fleet(tmp_path):
    f = Fleet(str(tmp_path / "ckpt"), 2)
    yield f
    f.close()


# --- placement --------------------------------------------------------------

def test_placement_is_deterministic(fleet):
    router = fleet.router()
    fleet.spread(router)
    p1 = router.placement()
    router2 = fleet.router()
    for tid, ep in p1.items():
        assert router2._place(tid) == ep


def test_survivor_placement_unchanged_by_host_death(fleet):
    router = fleet.router()
    ids = fleet.spread(router)
    placement = router.placement()
    victim = placement[ids[0]]
    survivors_before = {t: ep for t, ep in placement.items() if ep != victim}
    fleet.kill(victim)
    router.health()  # probe detects, migrates
    after = router.placement()
    for t, ep in survivors_before.items():
        assert after[t] == ep


@pytest.mark.parametrize("bad", [0, -1.0, float("nan"), float("inf"), "5"])
def test_router_deadline_knobs_validated_at_construction(bad):
    with pytest.raises(ValueError, match="request_timeout_s"):
        EvalRouter(["127.0.0.1:1"], request_timeout_s=bad, device="cpu")


@pytest.mark.parametrize("knob", ["reroute_grace_s", "probe_timeout_s", "latency_target_s"])
def test_router_own_knobs_validated(knob):
    with pytest.raises(ValueError, match=knob):
        EvalRouter(["127.0.0.1:1"], device="cpu", **{knob: -1.0})


def test_duplicate_attach_rejected(fleet):
    router = fleet.router()
    router.attach("a", SPEC)
    with pytest.raises(ServeError) as e:
        router.attach("a", SPEC)
    assert e.value.reason == "duplicate_tenant"


def test_duplicate_and_empty_endpoints_rejected():
    with pytest.raises(ValueError, match="at least one endpoint"):
        EvalRouter([], device="cpu")
    with pytest.raises(ValueError, match="duplicate endpoints"):
        EvalRouter(["127.0.0.1:1", ("127.0.0.1", 1)], device="cpu")


# --- the device -------------------------------------------------------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="the default is cuda:0 where a GPU is")
def test_default_device_raises_without_a_gpu():
    with pytest.raises(RuntimeError, match="No CUDA device"):
        EvalRouter(["127.0.0.1:1"])
    with pytest.raises(RuntimeError, match="No CUDA device"):
        EvalRouter(["127.0.0.1:1"], device="cuda")


def test_cpu_device_is_taken_as_given():
    r = EvalRouter(["127.0.0.1:1"], device="cpu")
    try:
        assert r._device == torch.device("cpu")
    finally:
        r.close()


# --- failure migration ------------------------------------------------------

def test_host_death_mid_stream_migrates_and_matches_oracle(fleet, obs_on):
    router = fleet.router()
    ids = fleet.spread(router)
    streams = {tid: [batch(i), batch(i + 100), batch(i + 200)] for i, tid in enumerate(ids)}
    for tid in ids:
        router.submit(tid, *streams[tid][0])
        router.flush(tid)  # batch 1 durable in the shared root
        router.submit(tid, *streams[tid][1])  # un-durable tail
    placement = router.placement()
    victim = placement[ids[0]]
    victims = [t for t, ep in placement.items() if ep == victim]
    fleet.kill(victim)
    for tid in ids:
        router.submit(tid, *streams[tid][2])
    for tid in ids:
        assert acc(router.compute(tid)) == oracle(streams[tid]), tid
    after = router.placement()
    for tid in victims:
        assert after[tid] != victim
    survivor = next(ep for ep in router.endpoints if ep != victim)
    health = fleet.daemon_for(survivor).health()
    for tid in victims:
        assert health["tenants"][tid]["processed"] == 2
        assert health["tenants"][tid]["dupes"] == 0
    assert obs_counts.count("serve.router.migrations") == len(victims)
    assert obs_counts.count("serve.router.migrations", reason="host_failure") == len(victims)
    # every victim replays its un-durable batch 2; the tenant whose submit
    # detected the death also replays the in-flight batch 3 it had booked
    assert obs_counts.count("serve.router.replays") == len(victims) + 1


def test_probe_failure_detects_and_migrates(fleet, obs_on):
    router = fleet.router()
    ids = fleet.spread(router)
    victim = router.placement()[ids[0]]
    fleet.kill(victim)
    rep = router.health()
    assert rep["hosts"][victim] is None
    assert victim not in rep["alive"]
    for ep in router.placement().values():
        assert ep != victim
    assert obs_counts.count("serve.router.probe_failures", endpoint=victim) >= 1


def test_health_probe_fails_fast_on_silent_host(fleet):
    silent = socket.create_server(("127.0.0.1", 0))
    try:
        silent_ep = f"127.0.0.1:{silent.getsockname()[1]}"
        router = fleet.router(
            [fleet.endpoints[0], silent_ep],
            probe_timeout_s=0.3,
            request_timeout_s=30.0,  # the probe must not use this
        )
        t0 = time.monotonic()
        rep = router.health()
        elapsed = time.monotonic() - t0
        assert rep["hosts"][silent_ep] is None
        assert rep["hosts"][fleet.endpoints[0]] is not None
        assert elapsed < 5.0
    finally:
        silent.close()


def test_all_hosts_dead_raises_no_hosts(fleet):
    router = fleet.router()
    router.attach("a", SPEC)
    for ep in list(fleet.endpoints):
        fleet.kill(ep)
    router.health()
    with pytest.raises(ServeError) as e:
        router.attach("b", SPEC)
    assert e.value.reason == "no_hosts"


def test_unknown_tenant_ops_raise(fleet):
    router = fleet.router()
    for op in (router.compute, router.flush, router.detach, router.sync_compute):
        with pytest.raises(ServeError) as e:
            op("nobody")
        assert e.value.reason == "unknown_tenant"


# --- drain ------------------------------------------------------------------

def test_drain_migrates_with_empty_tail(fleet, obs_on):
    router = fleet.router()
    ids = fleet.spread(router)
    streams = {tid: [batch(i), batch(i + 50)] for i, tid in enumerate(ids)}
    for tid in ids:
        router.submit(tid, *streams[tid][0])
    placement = router.placement()
    victim = placement[ids[0]]
    victims = [t for t, ep in placement.items() if ep == victim]
    out = router.drain(victim)
    assert sorted(out["migrated"]) == sorted(victims)
    assert sorted(out["drained"]) == sorted(victims)
    assert victim not in router.alive
    for tid in ids:
        router.submit(tid, *streams[tid][1])
        assert acc(router.compute(tid)) == oracle(streams[tid]), tid
    assert obs_counts.count("serve.router.migrations", reason="drain") == len(victims)
    assert obs_counts.count("serve.router.replays") == 0


def test_migration_span_lands_in_timeline(fleet, obs_on):
    router = fleet.router()
    ids = fleet.spread(router)
    router.drain(router.placement()[ids[0]])
    names = [e["name"] for e in json.loads(obs.chrome_trace())["traceEvents"]]
    assert "serve.router.migrate" in names


def test_drain_of_unknown_endpoint_raises(fleet):
    with pytest.raises(ValueError, match="unknown endpoint"):
        fleet.router().drain("127.0.0.1:1")


def test_detach_forgets_the_tenant(fleet):
    router = fleet.router()
    router.attach("a", SPEC)
    router.submit("a", *batch(1))
    router.detach("a")
    assert router.placement() == {}


# --- the JAX router's decisions on the same inputs --------------------------

def _endpoints(n, seed):
    rng = np.random.default_rng(seed)
    return [f"10.{rng.integers(0, 256)}.{rng.integers(0, 256)}.{i + 1}:{rng.integers(1024, 65536)}"
            for i in range(n)]


def _random_report(rng):
    return {
        "schema": 1,
        "draining": bool(rng.random() < 0.15),
        "capacity": {"max_tenants": int(rng.choice([0, 4, 8, 64])),
                     "active_tenants": int(rng.integers(0, 9))},
        "queue": {"depth": int(rng.integers(0, 300)), "capacity": int(rng.choice([0, 64, 256]))},
        "latency": {"submit_p99_s": float(rng.choice([0.0, rng.random() * 2.0])),
                    "submit_ewma_s": float(rng.random() * 0.5)},
        "hbm": {"bytes_sum": float(rng.random() * 4e9)},
    }


def _pair(endpoints, **kw):
    port = EvalRouter(endpoints, device="cpu", **kw)
    jax = jserve.EvalRouter(endpoints, **kw)
    return port, jax


TENANTS = [f"tenant-{i}" for i in range(200)]


@pytest.mark.parametrize("n", [2, 3, 4, 5])
@pytest.mark.parametrize("loads", ["none", "reports", "stale_and_suspect"])
def test_placement_equals_the_jax_routers(n, loads):
    eps = _endpoints(n, seed=n)
    port, jax = _pair(eps)
    try:
        rng = np.random.default_rng(100 + n)
        if loads != "none":
            for ep in eps:
                rep, age = _random_report(rng), 0.0
                if loads == "stale_and_suspect" and rng.random() < 0.5:
                    age = 999.0
                for r in (port, jax):
                    inject(r, ep, rep, age_s=age)
            if loads == "stale_and_suspect":
                for r in (port, jax):
                    with r._fleet_lock:
                        r._obs_subs[eps[0]] = object()
        got = [port._place(t) for t in TENANTS]
        want = [jax._place(t) for t in TENANTS]
        assert got == want
        assert len(set(got)) >= 1
        excl = frozenset(eps[:1])
        assert [port._place(t, exclude=excl) for t in TENANTS[:50]] == [
            jax._place(t, exclude=excl) for t in TENANTS[:50]
        ]
    finally:
        for r in (port, jax):
            with r._fleet_lock:
                r._obs_subs.clear()
            r.close()


@pytest.mark.parametrize("budget", [None, 2_000_000_000])
def test_host_load_equals_the_jax_routers(budget):
    eps = _endpoints(2, seed=7)
    port, jax = _pair(eps, latency_target_s=0.75, hbm_budget_bytes=budget)
    try:
        rng = np.random.default_rng(8)
        for _ in range(300):
            rep = _random_report(rng)
            assert port._host_load(rep) == jax._host_load(rep)
        for empty in (None, {}, {"schema": 1}):
            assert port._host_load(empty) == jax._host_load(empty) == 0.0
    finally:
        port.close()
        jax.close()


def test_fleet_status_headroom_equals_the_jax_routers():
    eps = _endpoints(4, seed=9)
    port, jax = _pair(eps)
    try:
        rng = np.random.default_rng(10)
        for ep in eps:
            rep = _random_report(rng)
            for r in (port, jax):
                inject(r, ep, rep)
        p, j = port.fleet_status(), jax.fleet_status()
        assert p["headroom"] == j["headroom"]
        for ep in eps:
            assert p["hosts"][ep]["load"] == j["hosts"][ep]["load"]
            assert p["hosts"][ep]["stale"] == j["hosts"][ep]["stale"]
    finally:
        port.close()
        jax.close()


def _statuses(seed, n=200):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        headroom = None if rng.random() < 0.1 else float(rng.random())
        yield {"headroom": headroom, "alive": [f"h{i}" for i in range(int(rng.integers(1, 7)))]}


@pytest.mark.parametrize(
    "kw",
    [
        dict(cooldown_s=0.0),
        dict(scale_up_below=0.5, cooldown_s=0.0, max_hosts=4),
        dict(scale_up_below=0.3, scale_down_above=0.6, min_hosts=2, max_hosts=5, cooldown_s=0.0),
        dict(cooldown_s=3600.0),
    ],
    ids=["defaults", "config9", "band", "cooldown"],
)
def test_scaling_decisions_equal_the_jax_policys(kw):
    port, jax = HeadroomScalingPolicy(**kw), jserve.HeadroomScalingPolicy(**kw)
    for status in _statuses(11):
        assert port.decide(status) == jax.decide(status)
