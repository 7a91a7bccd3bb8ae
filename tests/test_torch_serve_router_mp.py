"""The router drills with real processes, on the CPU: hosts chaos-killed
mid-window, a router killed mid-migration and restarted from its journal,
and an elastic scale-up with a host dying while it joins.

Counterparts: ``tests/serve/test_cluster_mp.py``,
``tests/serve/test_router_restart_mp.py`` and
``tests/serve/test_elastic_mp.py``. The processes are
``python -m torcheval_tpu_torch.utils.test_utils.serve_worker host|router``
(``serve_worker.Drill`` starts them on one checkpoint root); the router of
the cluster and elastic drills runs in this process with
``device="cpu"``. Batches are seeded by ``zlib.crc32`` of the tenant id.

Steady under a loaded runner: every wait polls to a generous deadline
(never a bare sleep), every process and producer thread has its own join
timeout, and every process is stopped or killed in ``finally``. No
request deadline has to fire early: a partitioned host is found by a
10 s request deadline on its own submits, while every answered request
completes far inside it, so a slow survivor is never mistaken for a
partition (the JAX drill's 1.5 s deadline is what a loaded runner can
miss).
"""

import json
import os
import threading

import pytest

from torcheval_tpu_torch import obs
from torcheval_tpu_torch.serve import EvalClient, EvalRouter, HeadroomScalingPolicy
from torcheval_tpu_torch.utils.test_utils import obs_counts
from torcheval_tpu_torch.utils.test_utils.router_fleet import wait
from torcheval_tpu_torch.utils.test_utils.serve_worker import (
    FIRST_ROUTER_BATCHES,
    DRILL_SPEC,
    Drill,
    drill_batch,
    drill_oracle,
)

CHAOS_EXIT_CODE = 43
ROUTER_KW = dict(device="cpu", request_timeout_s=10.0, connect_timeout_s=5.0, max_attempts=2,
                 backoff_base_s=0.05, backoff_cap_s=0.2)
THREAD_JOIN_S = 180.0


def _obs_threads():
    return [t.name for t in threading.enumerate()
            if "torcheval-tpu-obs-" in t.name or t.name == "torcheval-tpu-router-rebalance"]


def _run_producers(router, subsets, rounds):
    errors = []

    def produce(subset):
        try:
            for i in rounds:
                for t in subset:
                    router.submit(t, *drill_batch(t, i))
        except Exception as e:  # noqa: BLE001 - asserted by the caller
            errors.append(e)

    threads = [threading.Thread(target=produce, args=(s,), daemon=True) for s in subsets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(THREAD_JOIN_S)
    stuck = [t for t in threads if t.is_alive()]
    if stuck:
        errors.append(RuntimeError(f"{len(stuck)} producer thread(s) still running"))
    return errors


# --- the host-failure drill -------------------------------------------------

TENANTS_PER_HOST = 3
PHASE1, PHASE2 = 3, 3


def _spread_ids(router, per_host):
    counts = {ep: 0 for ep in router.alive}
    ids = []
    for i in range(256):
        if min(counts.values()) >= per_host:
            break
        tid, ep = f"t{i}", router._place(f"t{i}")
        if counts[ep] < per_host:
            counts[ep] += 1
            ids.append(tid)
    return ids


def _cluster_world(outdir, action):
    """Two hosts; B's chaos fires at its first phase-2 submit. Returns
    everything the tests read."""
    out = {}
    drill = Drill(outdir, os.path.join(outdir, "ckpt_root"))
    router = None
    obs.reset()
    obs.enable()
    try:
        ep_a = drill.host("hostA")
        ep_b = drill.host("hostB", chaos={
            "TORCHEVAL_TPU_CHAOS": "1",
            "TORCHEVAL_TPU_CHAOS_ACTION": action,
            "TORCHEVAL_TPU_CHAOS_TENANT": "*",
            "TORCHEVAL_TPU_CHAOS_STEP": str(PHASE1 + 1),
            "TORCHEVAL_TPU_CHAOS_EXIT_CODE": str(CHAOS_EXIT_CODE),
        })
        out.update(ep_a=ep_a, ep_b=ep_b)
        router = EvalRouter([ep_a, ep_b], pipeline_depth=3, **ROUTER_KW)
        tenants = _spread_ids(router, TENANTS_PER_HOST)
        for t in tenants:
            router.attach(t, DRILL_SPEC)
        before = router.placement()
        out["tenants"] = tenants
        out["b_tenants"] = [t for t, ep in before.items() if ep == ep_b]
        out["a_tenants"] = [t for t, ep in before.items() if ep == ep_a]

        # the fleet stream for the whole drill: pushes ride the wire and
        # add no collective round
        out["fleet_modes"] = router.subscribe_obs(0.25, stale_after_s=2.0)
        out["fleet_warmed"] = wait(
            lambda: all(not h["stale"] for h in router.fleet_status()["hosts"].values()), 60.0)
        probe = EvalClient(ep_a, request_timeout_s=30.0)
        rounds_before = probe.snapshot()["snapshot"]["counters"].get("toolkit.sync.rounds", 0)
        pushes_before = router.fleet_status()["hosts"][ep_a]["pushes"]
        out["fleet_pushed"] = wait(
            lambda: router.fleet_status()["hosts"][ep_a]["pushes"] >= pushes_before + 3, 60.0)
        out["sync_rounds"] = (
            rounds_before, probe.snapshot()["snapshot"]["counters"].get("toolkit.sync.rounds", 0))
        probe.close()

        for i in range(PHASE1):
            for t in tenants:
                router.submit(t, *drill_batch(t, i))
        for t in tenants:
            router.flush(t)

        def fleet_sees_ingest():
            lr = router.fleet_status()["hosts"][ep_a]["load_report"]
            return (lr is not None and any(t in lr["queue"]["per_tenant"] for t in out["a_tenants"])
                    and lr["latency"]["submit_ewma_s"] > 0.0)

        out["fleet_saw_ingest"] = wait(fleet_sees_ingest, 60.0)
        out["producer_errors"] = _run_producers(
            router, [tenants[::2], tenants[1::2]], range(PHASE1, PHASE1 + PHASE2))
        out["results"] = {t: float(router.compute(t)["acc"]) for t in tenants}
        out["placement_after"] = router.placement()
        if action != "host_partition":
            out["b_stale"] = wait(
                lambda: router.fleet_status()["hosts"].get(ep_b, {}).get("stale", False), 60.0)
        out["fleet_status"] = router.fleet_status()
        out["router_snapshot"] = obs.snapshot()
        out["router_trace"] = json.loads(obs.chrome_trace())
        out["fleet_trace"] = json.loads(router.fleet_chrome_trace())
        client_a = EvalClient(ep_a, request_timeout_s=30.0)
        out["a_counters"] = client_a.snapshot()["snapshot"]["counters"]
        out["a_health"] = client_a.health()
        client_a.close()
    finally:
        if router is not None:
            router.close()
        out["codes"] = drill.close()
        obs.disable()
    out["leaked_threads"] = [] if wait(lambda: not _obs_threads(), 30.0) else _obs_threads()
    return out


ACTIONS = ["host_kill", "ack_drop", "host_partition"]


@pytest.fixture(scope="module", params=ACTIONS)
def cluster(request, tmp_path_factory):
    out = _cluster_world(str(tmp_path_factory.mktemp(f"cluster_{request.param}")), request.param)
    out["action"] = request.param
    return out


def test_both_hosts_held_tenants_before_the_fault(cluster):
    assert cluster["a_tenants"] and cluster["b_tenants"]


def test_producers_saw_no_errors(cluster):
    assert cluster["producer_errors"] == []


def test_every_tenant_finished_on_host_a(cluster):
    for t, ep in cluster["placement_after"].items():
        assert ep == cluster["ep_a"], t


def test_results_bit_identical_to_fault_free_oracle(cluster):
    for t in cluster["tenants"]:
        assert cluster["results"][t] == drill_oracle(t, PHASE1 + PHASE2), t


def test_zero_duplicate_application_on_survivor(cluster):
    counters, tenants = cluster["a_counters"], cluster["a_health"]["tenants"]
    for t in cluster["b_tenants"]:
        assert tenants[t]["processed"] == PHASE2, tenants[t]
        assert tenants[t]["dupes"] == 0, t
        assert counters.get(f"serve.ingest.batches{{tenant={t}}}") == PHASE2, t
        assert tenants[t]["durable_seq"] >= PHASE1, t
    for t in cluster["a_tenants"]:
        assert tenants[t]["processed"] == PHASE1 + PHASE2, t
        assert tenants[t]["dupes"] == 0, t


def test_router_migration_counters_and_span_recorded(cluster):
    snap = cluster["router_snapshot"]
    assert obs_counts.count("serve.router.migrations", snap, reason="host_failure") == len(
        cluster["b_tenants"])
    replays = obs_counts.count("serve.router.replays", snap)
    assert 1 <= replays <= PHASE2 * len(cluster["b_tenants"])
    assert "serve.router.migrate" in [e["name"] for e in cluster["router_trace"]["traceEvents"]]


def test_fleet_stream_rode_the_wire_for_free(cluster):
    assert cluster["fleet_modes"] == {cluster["ep_a"]: "push", cluster["ep_b"]: "push"}
    assert cluster["fleet_warmed"] and cluster["fleet_pushed"] and cluster["fleet_saw_ingest"]
    before, after = cluster["sync_rounds"]
    assert before == after


def test_dead_host_marked_stale_not_dropped(cluster):
    if cluster["action"] == "host_partition":
        # the partitioned process keeps its publisher: never stale
        assert cluster["ep_b"] in cluster["fleet_status"]["hosts"]
        return
    assert cluster["b_stale"]
    assert cluster["fleet_status"]["hosts"][cluster["ep_b"]]["stale"]


def test_host_b_exit_code(cluster):
    # killed hosts leave with the chaos code; a partitioned one survives,
    # abandoned, until it is told to stop
    want = 0 if cluster["action"] == "host_partition" else CHAOS_EXIT_CODE
    assert cluster["codes"]["hostB"] == want
    assert cluster["codes"]["hostA"] == 0


def test_fleet_trace_tags_host_events(cluster):
    assert cluster["ep_a"] in {e.get("pid") for e in cluster["fleet_trace"]["traceEvents"]}


def test_no_subscriber_threads_leaked(cluster):
    assert cluster["leaked_threads"] == []


# --- the router-restart drill -----------------------------------------------

RESTART_PHASE2 = 5
ROUTER_KILL_CODE = 47


@pytest.fixture(scope="module")
def restart(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("router_restart"))
    journal_dir = os.path.join(outdir, "journal")
    drill = Drill(outdir, os.path.join(outdir, "ckpt_root"))
    out = {}
    router = None
    obs.reset()
    obs.enable()
    try:
        endpoints = [drill.host(tag) for tag in ("hostA", "hostB", "hostC")]
        drill.spawn("first_router", ["router", outdir, journal_dir, ",".join(endpoints)], chaos={
            "TORCHEVAL_TPU_CHAOS": "1",
            "TORCHEVAL_TPU_CHAOS_ACTION": "router_kill",
            "TORCHEVAL_TPU_CHAOS_TENANT": "*",
            "TORCHEVAL_TPU_CHAOS_STEP": "1",
            "TORCHEVAL_TPU_CHAOS_POINT": "migrate_exported",
            "TORCHEVAL_TPU_CHAOS_EXIT_CODE": str(ROUTER_KILL_CODE),
        })
        out["first_router_rc"] = drill.join("first_router", 300.0)
        out["first_router_log"] = drill.log("first_router")
        with open(os.path.join(outdir, "first_router.state.json")) as f:
            out["first_router_state"] = json.load(f)
        router = EvalRouter(endpoints, journal_dir=journal_dir, **ROUTER_KW)
        out["recovery"] = dict(router.last_recovery)
        out["placement_after"] = router.placement()
        for i in range(FIRST_ROUTER_BATCHES, FIRST_ROUTER_BATCHES + RESTART_PHASE2):
            for t in ("solo", "fan"):
                router.submit(t, *drill_batch(t, i))
        for t in ("solo", "fan"):
            router.flush(t)
        out["results"] = {t: float(router.compute(t)["acc"]) for t in ("solo", "fan")}
        out["dupes"] = {}
        for ep in endpoints:
            client = EvalClient(ep, request_timeout_s=30.0)
            out["dupes"][ep] = {t: i.get("dupes", 0) for t, i in client.health()["tenants"].items()}
            client.close()
        out["snapshot_written"] = os.path.getsize(os.path.join(journal_dir, "snapshot.json")) > 0
    finally:
        if router is not None:
            router.close()
        drill.close()
        obs.disable()
    out["leaked_threads"] = [] if wait(lambda: not _obs_threads(), 30.0) else _obs_threads()
    return out


def test_chaos_killed_the_router_mid_migration(restart):
    assert restart["first_router_rc"] == ROUTER_KILL_CODE, restart["first_router_log"][-2000:]


def test_recovery_reconciled_every_tenant(restart):
    outcomes = restart["recovery"]["outcomes"]
    assert outcomes.get("replaced", 0) >= 1
    assert sum(outcomes.values()) == 3  # solo, fan, fan@r1
    assert sorted(restart["placement_after"]) == sorted(restart["first_router_state"]["placement"])
    victim = restart["first_router_state"]["victim"]
    assert victim in restart["recovery"]["drained"]
    assert all(ep != victim for ep in restart["placement_after"].values())


def test_restart_results_bit_identical_to_fault_free_oracles(restart):
    for t in ("solo", "fan"):
        assert restart["results"][t] == drill_oracle(t, FIRST_ROUTER_BATCHES + RESTART_PHASE2), t


def test_restart_zero_duplicate_application(restart):
    for ep, dupes in restart["dupes"].items():
        assert all(n == 0 for n in dupes.values()), (ep, dupes)


def test_restart_blackout_measured_and_bounded(restart):
    assert 0.0 < restart["recovery"]["duration_s"] < 60.0
    assert restart["snapshot_written"]


def test_restart_no_threads_leaked(restart):
    assert restart["leaked_threads"] == []


# --- the elastic scale-up drill ---------------------------------------------

EL_PHASE1, EL_PHASE2 = 2, 3
HOT_DELAY_S = 0.4
LATENCY_TARGET_S = 0.5
COLD = ("t0", "t1")


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("elastic"))
    drill = Drill(outdir, os.path.join(outdir, "ckpt_root"))
    out = {}
    router = None
    obs.reset()
    obs.enable()
    try:
        ep_a = drill.host("hostA", chaos={
            "TORCHEVAL_TPU_CHAOS": "1",
            "TORCHEVAL_TPU_CHAOS_ACTION": "load_spike",
            "TORCHEVAL_TPU_CHAOS_TENANT": "hot",
            "TORCHEVAL_TPU_CHAOS_STEP": "1",
            "TORCHEVAL_TPU_CHAOS_DELAY_S": str(HOT_DELAY_S),
        })
        out["ep_a"] = ep_a
        router = EvalRouter([ep_a], latency_target_s=LATENCY_TARGET_S, **ROUTER_KW)
        router.subscribe_obs(0.25, stale_after_s=2.0)
        tenants = COLD + ("hot",)
        for t in tenants:
            router.attach(t, DRILL_SPEC)
        for i in range(EL_PHASE1):
            for t in tenants:
                router.submit(t, *drill_batch(t, i))
        for t in tenants:
            router.flush(t)
        out["starved"] = wait(lambda: (router.fleet_status()["headroom"] or 1.0) < 0.55, 60.0)
        out["headroom_before"] = router.fleet_status()["headroom"]
        policy = HeadroomScalingPolicy(scale_up_below=0.55, cooldown_s=0.0)
        out["scale_delta"] = router.autoscale_step(policy, provision=lambda: drill.host("hostB"))
        ep_b = next(ep for ep in router.alive if ep != ep_a)
        out["ep_b"] = ep_b
        out["b_fresh"] = wait(
            lambda: not router.fleet_status()["hosts"].get(ep_b, {"stale": True})["stale"], 60.0)
        out["moved"] = router.rebalance(hot_load=0.5, improvement=0.2, min_dwell_s=0.0, max_moves=2)
        out["second_pass"] = router.rebalance(hot_load=0.5, improvement=0.2, min_dwell_s=60.0,
                                              max_moves=2)
        out["split"] = router.split_tenant("hot", replicas=2)
        for i in range(EL_PHASE1, EL_PHASE1 + EL_PHASE2):
            for t in tenants:
                router.submit(t, *drill_batch(t, i))
        ep_c = drill.host("hostC", chaos={
            "TORCHEVAL_TPU_CHAOS": "1",
            "TORCHEVAL_TPU_CHAOS_ACTION": "host_kill",
            "TORCHEVAL_TPU_CHAOS_TENANT": "*",
            "TORCHEVAL_TPU_CHAOS_STEP": "1",
            "TORCHEVAL_TPU_CHAOS_EXIT_CODE": str(CHAOS_EXIT_CODE),
        })
        out["ep_c"] = ep_c
        router.add_host(ep_c)
        late = next(t for t in (f"late{i}" for i in range(256)) if router._place(t) == ep_c)
        out["late"] = late
        router.attach(late, DRILL_SPEC)
        for i in range(2):
            router.submit(late, *drill_batch(late, i))
        for t in tenants + (late,):
            router.flush(t)
        out["results"] = {t: float(router.compute(t)["acc"]) for t in tenants + (late,)}
        out["placement_after"] = router.placement()
        out["alive_after"] = router.alive
        out["host_counters"], out["host_reports"] = {}, {}
        for ep in (ep_a, ep_b):
            client = EvalClient(ep, request_timeout_s=30.0)
            out["host_counters"][ep] = client.snapshot()["snapshot"]["counters"]
            out["host_reports"][ep] = client.load_report()
            client.close()
        out["router_snapshot"] = obs.snapshot()
    finally:
        if router is not None:
            router.close()
        out["codes"] = drill.close()
        obs.disable()
    out["leaked_threads"] = [] if wait(lambda: not _obs_threads(), 30.0) else _obs_threads()
    return out


def test_load_spike_starved_headroom(elastic):
    assert elastic["starved"] and elastic["headroom_before"] < 0.55


def test_policy_scaled_up_one_real_host(elastic):
    assert elastic["scale_delta"] == 1
    assert elastic["ep_b"] in elastic["alive_after"] and elastic["b_fresh"]


def test_rebalance_moved_bounded_and_no_thrash(elastic):
    assert 1 <= len(elastic["moved"]) <= 2
    for t in elastic["moved"]:
        assert elastic["placement_after"][t] == elastic["ep_b"], t
    assert elastic["second_pass"] == []


def test_hot_tenant_split_spans_hosts(elastic):
    assert sorted(elastic["split"]) == ["hot", "hot@r1"]
    assert len(set(elastic["split"].values())) == 2


def test_chaos_killed_host_c_mid_scale_up(elastic):
    assert elastic["codes"]["hostC"] == CHAOS_EXIT_CODE
    assert elastic["ep_c"] not in elastic["alive_after"]
    assert elastic["placement_after"][elastic["late"]] != elastic["ep_c"]


def test_elastic_results_bit_identical_to_fault_free_oracles(elastic):
    for t in COLD + ("hot",):
        assert elastic["results"][t] == drill_oracle(t, EL_PHASE1 + EL_PHASE2), t
    assert elastic["results"][elastic["late"]] == drill_oracle(elastic["late"], 2)


def test_zero_sheds_and_drained_queues_after_scale_up(elastic):
    for ep, counters in elastic["host_counters"].items():
        assert not [k for k in counters if k.startswith("serve.ingest.sheds{")], ep
    for ep, rep in elastic["host_reports"].items():
        assert rep["queue"]["depth"] == 0, ep


def test_router_recorded_rebalance_and_split_instruments(elastic):
    snap = elastic["router_snapshot"]
    assert obs_counts.count("serve.router.migrations", snap, reason="rebalance") >= 1
    assert obs_counts.count("serve.router.splits", snap, tenant="hot") == 1
    assert obs_counts.count("serve.router.rebalances", snap) >= 1
    assert "serve.fleet.headroom" in snap["gauges"]


def test_elastic_no_threads_leaked(elastic):
    assert elastic["leaked_threads"] == []
