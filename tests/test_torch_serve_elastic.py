"""The elastic fleet on the CPU: load-aware placement, the hysteretic
rebalancer, runtime ``add_host``/``remove_host``, the scaling policy, and
the router's fleet fold of the obs push channel.

Counterparts: ``tests/serve/test_elastic.py`` and the fleet half of
``tests/serve/test_obs_stream.py`` (``TestRouterFleet``: a push host
beside an old peer that rejects ``subscribe_obs`` and is polled). Load
reports are injected into the router's folded fleet state, so every
decision path runs deterministically; the fleet half streams real pushes.
In-process hosts on one checkpoint root, every socket on port 0.
"""

import json
import threading

import numpy as np
import pytest

from torcheval_tpu_torch import obs
from torcheval_tpu_torch.serve import HeadroomScalingPolicy, ScalingPolicy, ServeError, WireError
from torcheval_tpu_torch.serve import EvalServer, metric_spec
from torcheval_tpu_torch.utils.test_utils import obs_counts
from torcheval_tpu_torch.utils.test_utils.router_fleet import (
    SPEC,
    Fleet,
    acc,
    batch,
    inject,
    oracle,
    report,
    wait,
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


# --- weighted placement -----------------------------------------------------

def test_no_load_signal_is_classic_rendezvous(fleet):
    r1, r2 = fleet.router(), fleet.router()
    for i in range(64):
        assert r1._place(f"t{i}") == r2._place(f"t{i}")


def test_hot_host_repels_new_tenants(fleet):
    router = fleet.router()
    hot, cold = router.endpoints
    inject(router, hot, report(p99_s=10.0))  # load -> 0.999
    inject(router, cold, report(p99_s=0.0))
    placed = [router._place(f"t{i}") for i in range(100)]
    assert sum(ep == hot for ep in placed) <= 5
    assert placed == [router._place(f"t{i}") for i in range(100)]


def test_stale_report_carries_no_weight(fleet):
    router, router2 = fleet.router(), fleet.router()
    inject(router, router.endpoints[0], report(p99_s=10.0), age_s=999.0)
    for i in range(32):
        assert router._place(f"t{i}") == router2._place(f"t{i}")


def test_draining_host_ineligible_for_new_tenants(fleet):
    router = fleet.router()
    eps = router.endpoints
    inject(router, eps[0], report(draining=True))
    for i in range(32):
        assert router._place(f"t{i}") == eps[1]
    inject(router, eps[1], report(draining=True))  # unless that empties the set
    assert router._place("t0") in eps


def test_silent_subscribed_host_is_suspect(fleet):
    router = fleet.router()
    eps = router.endpoints
    inject(router, eps[0], report(), age_s=999.0)
    with router._fleet_lock:
        router._obs_subs[eps[0]] = object()
    try:
        for i in range(32):
            assert router._place(f"t{i}") == eps[1]
    finally:
        with router._fleet_lock:
            router._obs_subs.pop(eps[0], None)


# --- headroom ---------------------------------------------------------------

def test_headroom_none_without_reports(fleet):
    status = fleet.router().fleet_status()
    assert status["schema"] == 1 and status["headroom"] is None
    for host in status["hosts"].values():
        assert "load" in host


def test_headroom_folds_fresh_loads(fleet):
    router = fleet.router()
    eps = router.endpoints
    inject(router, eps[0], report(p99_s=0.6))
    inject(router, eps[1], report(p99_s=0.2))
    status = router.fleet_status()
    assert status["headroom"] == pytest.approx(0.6, abs=1e-6)
    assert status["hosts"][eps[0]]["load"] == pytest.approx(0.6, abs=1e-6)


def test_headroom_gauge_emitted(fleet, obs_on):
    router = fleet.router()
    inject(router, router.endpoints[0], report(p99_s=0.5))
    router.fleet_status()
    assert "serve.fleet.headroom" in obs.snapshot()["gauges"]


# --- rebalance --------------------------------------------------------------

def _skew(router, hot_ep, cold_ep, hot=0.9, cold=0.1):
    inject(router, hot_ep, report(p99_s=hot))
    inject(router, cold_ep, report(p99_s=cold))


def test_rebalance_moves_off_hot_host_exactly_once(fleet, obs_on):
    router = fleet.router()
    router.attach("ten", SPEC)
    src = router.placement()["ten"]
    dst = next(ep for ep in router.endpoints if ep != src)
    stream = [batch(1), batch(2), batch(3)]
    router.submit("ten", *stream[0])
    router.flush("ten")  # durable
    router.submit("ten", *stream[1])  # un-durable tail
    _skew(router, src, dst)
    assert router.rebalance(min_dwell_s=0.0) == ["ten"]
    assert router.placement()["ten"] == dst
    router.submit("ten", *stream[2])
    assert acc(router.compute("ten")) == oracle(stream)
    assert fleet.daemon_for(dst).health()["tenants"]["ten"]["dupes"] == 0
    assert obs_counts.count("serve.router.migrations", reason="rebalance") == 1
    assert obs_counts.count("serve.router.rebalances", endpoint=src) == 1
    for _ in range(5):  # the dwell clock restarted: no bounce back
        assert router.rebalance(min_dwell_s=60.0) == []
    assert router.placement()["ten"] == dst


def test_improvement_threshold_blocks_marginal_moves(fleet):
    router = fleet.router()
    router.attach("ten", SPEC)
    src = router.placement()["ten"]
    dst = next(ep for ep in router.endpoints if ep != src)
    _skew(router, src, dst, hot=0.8, cold=0.7)
    assert router.rebalance(min_dwell_s=0.0, improvement=0.15) == []
    assert router.placement()["ten"] == src


def test_max_moves_bounds_one_pass(fleet):
    router = fleet.router()
    fleet.spread(router)
    src, dst = router.endpoints
    _skew(router, src, dst)
    moved = router.rebalance(min_dwell_s=0.0, max_moves=2)
    assert 1 <= len(moved) <= 2


def test_bad_max_moves_rejected(fleet):
    with pytest.raises(ValueError, match="max_moves"):
        fleet.router().rebalance(max_moves=0)


def test_no_fresh_loads_means_no_moves(fleet):
    router = fleet.router()
    router.attach("ten", SPEC)
    assert router.rebalance(min_dwell_s=0.0) == []


def _rebalancer_threads():
    return [t for t in threading.enumerate() if t.name == "torcheval-tpu-router-rebalance"]


def test_background_rebalancer_thread_lifecycle(fleet):
    router = fleet.router()
    router.start_rebalancer(interval_s=0.05, min_dwell_s=0.0)
    assert _rebalancer_threads()
    # passes with no load data are no-ops, not crashes
    assert wait(lambda: router._rebalance_thread.is_alive(), timeout_s=1.0)
    router.stop_rebalancer()
    assert wait(lambda: not _rebalancer_threads(), timeout_s=10.0)


# --- hosts joining and leaving ----------------------------------------------

def test_add_host_joins_placement(fleet):
    router = fleet.router()
    new_ep = fleet.start_host()
    assert new_ep not in router.endpoints
    router.add_host(new_ep)
    assert new_ep in router.alive
    tid = next((f"j{i}" for i in range(64) if router._place(f"j{i}") == new_ep), None)
    assert tid is not None
    assert router.attach(tid, SPEC) == new_ep
    b = batch(3)
    router.submit(tid, *b)
    assert acc(router.compute(tid)) == oracle([b])


def test_add_live_host_twice_rejected(fleet):
    router = fleet.router()
    with pytest.raises(ValueError, match="already in the fleet"):
        router.add_host(router.endpoints[0])


def test_remove_host_drains_and_forgets(fleet):
    router = fleet.router()
    router.attach("ten", SPEC)
    src = router.placement()["ten"]
    b1, b2 = batch(1), batch(2)
    router.submit("ten", *b1)
    out = router.remove_host(src)
    assert "ten" in out["migrated"]
    assert src not in router.endpoints and src not in router.alive
    router.submit("ten", *b2)
    assert acc(router.compute("ten")) == oracle([b1, b2])


def test_remove_unknown_host_raises(fleet):
    with pytest.raises(ValueError, match="unknown endpoint"):
        fleet.router().remove_host("127.0.0.1:1")


def test_autoscale_scales_up_on_low_headroom(fleet):
    router = fleet.router()
    for ep in router.endpoints:
        inject(router, ep, report(p99_s=0.95))
    provisioned = []

    def provision():
        provisioned.append(fleet.start_host())
        return provisioned[-1]

    policy = HeadroomScalingPolicy(scale_up_below=0.2, cooldown_s=0.0)
    assert router.autoscale_step(policy, provision=provision) == 1
    assert len(provisioned) == 1 and provisioned[0] in router.alive


def test_autoscale_scales_down_on_high_headroom(fleet):
    router = fleet.router()
    for ep in router.endpoints:
        inject(router, ep, report(p99_s=0.01))
    removed = []
    policy = HeadroomScalingPolicy(scale_down_above=0.8, min_hosts=1, cooldown_s=0.0)
    assert router.autoscale_step(policy, decommission=removed.append) == -1
    assert len(removed) == 1 and removed[0] not in router.endpoints
    assert len(router.alive) == 1


def test_autoscale_without_hooks_only_decides(fleet):
    router = fleet.router()
    for ep in router.endpoints:
        inject(router, ep, report(p99_s=0.95))
    policy = HeadroomScalingPolicy(scale_up_below=0.2, cooldown_s=0.0)
    assert router.autoscale_step(policy) == 1
    assert len(router.alive) == 2


# --- the policy -------------------------------------------------------------

def test_base_policy_is_abstract():
    with pytest.raises(NotImplementedError):
        ScalingPolicy().decide({})


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(scale_up_below=0.8, scale_down_above=0.2), "dead band"),
        (dict(min_hosts=0), "min_hosts"),
        (dict(min_hosts=3, max_hosts=2), "max_hosts"),
        (dict(cooldown_s=-1), "cooldown_s"),
    ],
)
def test_knob_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        HeadroomScalingPolicy(**kw)


def test_no_signal_holds():
    assert HeadroomScalingPolicy(cooldown_s=0.0).decide({"headroom": None, "alive": ["a"]}) == 0


def test_band_and_bounds():
    policy = HeadroomScalingPolicy(
        scale_up_below=0.2, scale_down_above=0.8, min_hosts=1, max_hosts=2, cooldown_s=0.0
    )
    assert policy.decide({"headroom": 0.1, "alive": ["a"]}) == 1
    assert policy.decide({"headroom": 0.1, "alive": ["a", "b"]}) == 0  # at max_hosts
    assert policy.decide({"headroom": 0.5, "alive": ["a", "b"]}) == 0  # the dead band
    assert policy.decide({"headroom": 0.9, "alive": ["a", "b"]}) == -1
    assert policy.decide({"headroom": 0.9, "alive": ["a"]}) == 0  # at min_hosts


def test_cooldown_quiets_consecutive_decisions():
    policy = HeadroomScalingPolicy(cooldown_s=60.0)
    assert policy.decide({"headroom": 0.1, "alive": ["a"]}) == 1
    assert policy.decide({"headroom": 0.1, "alive": ["a"]}) == 0


def test_sync_compute_refused_for_split_tenant(fleet):
    router = fleet.router()
    router.attach("ten", SPEC)
    router.split_tenant("ten", replicas=2)
    with pytest.raises(ServeError) as e:
        router.sync_compute("ten")
    assert e.value.reason == "split_tenant"


# --- the fleet fold of the push channel -------------------------------------

class _OldServer(EvalServer):
    """A peer that predates ``subscribe_obs``: the op is refused."""

    def _handle(self, op, header, payload, stage_box=None):
        if op == "subscribe_obs":
            raise WireError("protocol", f"unknown wire op {op!r}.")
        return super()._handle(op, header, payload, stage_box)


@pytest.fixture
def mixed(tmp_path, obs_on):
    """A push host (the first) and an old, polled peer (the second)."""
    f = Fleet(str(tmp_path / "ckpt"), 2, last_server_cls=_OldServer)
    f.r = f.router(request_timeout_s=30.0)
    yield f
    f.close()


SPEC4 = {"acc": metric_spec("MulticlassAccuracy", num_classes=4)}


def _zeros(n=8):
    return np.zeros(n, np.int64), np.zeros(n, np.int64)


def _no_obs_threads():
    return not [t.name for t in threading.enumerate() if "torcheval-tpu-obs-" in t.name]


def test_fleet_status_folds_mixed_version_hosts(mixed):
    push_ep, poll_ep = mixed.endpoints
    modes = mixed.r.subscribe_obs(0.1)
    assert modes == {push_ep: "push", poll_ep: "poll"}
    assert wait(lambda: all(not h["stale"] for h in mixed.r.fleet_status()["hosts"].values()))
    fs = mixed.r.fleet_status()
    for ep in (push_ep, poll_ep):
        assert fs["hosts"][ep]["alive"] and fs["hosts"][ep]["load_report"]["schema"] == 1
    assert fs["hosts"][push_ep]["mode"] == "push" and fs["hosts"][poll_ep]["mode"] == "poll"


def test_fleet_status_reflects_ingest_within_one_interval(mixed):
    mixed.r.subscribe_obs(0.1)
    ep = mixed.r.attach("t1", SPEC4)
    for _ in range(3):
        mixed.r.submit("t1", *_zeros())

    def sees_ingest():
        lr = mixed.r.fleet_status()["hosts"][ep]["load_report"]
        return lr is not None and "t1" in lr["queue"]["per_tenant"] and lr["latency"]["submit_ewma_s"] > 0.0

    assert wait(sees_ingest)


def test_killed_host_goes_stale_within_horizon(mixed):
    push_ep = mixed.endpoints[0]
    mixed.r.subscribe_obs(0.1, stale_after_s=0.5)
    assert wait(lambda: not mixed.r.fleet_status()["hosts"][push_ep]["stale"])
    mixed.kill(push_ep)  # without telling the router
    assert wait(lambda: mixed.r.fleet_status()["hosts"][push_ep]["stale"])
    assert push_ep in mixed.r.alive  # the failure detector still decides eviction


def test_unsubscribe_stops_all_stream_threads(mixed):
    mixed.r.subscribe_obs(0.05)
    assert wait(lambda: any(h["pushes"] > 0 for h in mixed.r.fleet_status()["hosts"].values()))
    mixed.r.unsubscribe_obs()
    assert wait(_no_obs_threads)


def test_fleet_chrome_trace_tags_events_per_host(mixed):
    mixed.r.subscribe_obs(0.1)
    mixed.r.attach("t1", SPEC4)
    mixed.r.submit("t1", *_zeros())
    push_ep = mixed.endpoints[0]

    def host_events_arrived():
        trace = json.loads(mixed.r.fleet_chrome_trace())
        return push_ep in {e.get("pid") for e in trace["traceEvents"]}

    assert wait(host_events_arrived)


def test_fleet_snapshot_folds_the_hosts_registry(mixed):
    push_ep = mixed.endpoints[0]
    mixed.r.subscribe_obs(0.05)
    mixed.r.attach("t1", SPEC4)
    mixed.r.submit("t1", *_zeros())
    assert wait(lambda: mixed.r.fleet_status()["hosts"][push_ep]["pushes"] > 0)
    assert wait(lambda: obs_counts.count(
        "serve.ingest.batches", mixed.r.fleet_snapshot(push_ep), tenant="t1") >= 1)
    with pytest.raises(ValueError, match="no obs stream state"):
        mixed.r.fleet_snapshot("127.0.0.1:1")


def test_resubscribe_is_idempotent(mixed):
    mixed.r.subscribe_obs(0.1)
    mixed.r.subscribe_obs(0.1)  # drops and replaces the streams
    assert wait(lambda: any(not h["stale"] for h in mixed.r.fleet_status()["hosts"].values()))
    mixed.r.unsubscribe_obs()
    assert wait(_no_obs_threads)


def test_subscribe_knobs_validated(mixed):
    with pytest.raises(ValueError):
        mixed.r.subscribe_obs(0.0)
    with pytest.raises(ValueError, match="max_events"):
        mixed.r.subscribe_obs(0.1, max_events=-1)
