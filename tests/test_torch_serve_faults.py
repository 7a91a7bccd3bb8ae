"""Serve fault containment in four real gloo processes: the port's
counterpart of ``tests/serve/test_serve_faults_mp.py``.

Two worlds of ``torcheval_tpu_torch.utils.test_utils.serve_worker``, one
daemon a rank:

* **poison containment**: chaos turns one tenant's batch to NaN on rank 1;
  that tenant alone, on that rank alone, ends quarantined with the
  structured reason, and every other tenant's values on every rank equal a
  fault-free oracle (the port's own metric with the same compute cadence)
  and the JAX package's within rtol 1e-5;
* **eviction resume**: a tenant evicted mid-stream re-attaches with
  ``resume="require"`` and finishes bit for bit;
* **sync degradation through the daemon**: with rank 2 killed (kill
  world) or straggling (delay world) in sync B, the other daemons'
  ``sync_compute(timeout_s=, on_failure="local")`` returns each rank's
  LOCAL value within the deadline, after a healthy sync A returned the
  global value.
"""

import json
import os
import shutil
import tempfile

import numpy as np
import pytest

import torcheval_tpu.metrics as jm
import torcheval_tpu_torch.metrics as tm
from torcheval_tpu_torch.utils.test_utils import serve_worker as sw

WORLD = 4
LAUNCH_TIMEOUT_S = 240.0


def _oracle(rank, tenant, phases=(0,), M=tm, **kw):
    """The metric driven with the daemon's compute cadence (one compute a
    phase), so the fold grouping and the float32 sums are the same."""
    m = M.MulticlassAccuracy(num_classes=sw.NUM_CLASSES, **kw)
    val = None
    for ph in phases:
        for s, l in sw.tenant_stream(rank, tenant, phases=(ph,)):
            m.update(s, l)
        val = float(np.asarray(m.compute()))
    return val


def _port_oracle(rank, tenant, phases=(0,)):
    return _oracle(rank, tenant, phases, tm, device="cpu")


def _world(action):
    outdir = tempfile.mkdtemp(prefix=f"torch_serve_{action}_")
    codes, outs, results = sw.launch(action, outdir, LAUNCH_TIMEOUT_S, WORLD)
    return outdir, codes, outs, results


@pytest.fixture(scope="module", params=["kill", "delay"])
def world(request):
    outdir, codes, outs, results = _world(request.param)
    yield request.param, outdir, codes, outs, results
    shutil.rmtree(outdir, ignore_errors=True)


def _survivors(action):
    return [r for r in range(WORLD) if not (action == "kill" and r == sw.FAULT_RANK)]


def test_survivors_exited_cleanly_and_the_fault_rank_as_armed(world):
    action, _, codes, outs, results = world
    for r in _survivors(action):
        assert codes[r] == 0, f"rank {r} exited {codes[r]}:\n{outs[r][-4000:]}"
    if action == "kill":
        assert codes[sw.FAULT_RANK] == sw.CHAOS_EXIT_CODE, outs[sw.FAULT_RANK][-3000:]
        assert results[sw.FAULT_RANK] is None


def test_poisoned_tenant_quarantined_only_where_poisoned(world):
    action, _, _, _, results = world
    res = results[sw.POISON_RANK]
    assert res["bob_quarantined"]["reason"] == "nan_policy"
    assert res["bob_quarantined"]["tenant"] == "bob"
    for r in _survivors(action):
        if r != sw.POISON_RANK:
            assert results[r]["bob_phase0"] == _port_oracle(r, "bob")


def test_other_tenants_equal_the_fault_free_oracles(world):
    action, _, _, _, results = world
    for r in _survivors(action):
        res = results[r]
        assert res["alice_phase0"] == _port_oracle(r, "alice")
        assert res["carol_resumed"] == _port_oracle(r, "carol", phases=(0, 1))
        assert res["carol_ckpt_exists"]
        np.testing.assert_allclose(res["alice_phase0"], _oracle(r, "alice", M=jm), rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(
            res["carol_resumed"], _oracle(r, "carol", phases=(0, 1), M=jm), rtol=1e-5, atol=1e-8
        )


def test_healthy_sync_returned_the_global_value(world):
    action, _, _, _, results = world
    batches = [b for r in range(WORLD) for b in sw.tenant_stream(r, "alice")]
    scores = np.concatenate([s for s, _ in batches])
    labels = np.concatenate([l for _, l in batches])
    want = float((scores.argmax(1) == labels).mean())
    for r in _survivors(action):
        assert results[r]["alice_syncA"] == pytest.approx(want, abs=1e-6)


def test_faulted_sync_degraded_to_local_within_the_deadline(world):
    action, _, _, _, results = world
    for r in _survivors(action):
        res = results[r]
        assert res["alice_syncB"] == res["alice_local_post"] == _port_oracle(r, "alice", phases=(0, 1))
        if r == sw.FAULT_RANK:  # the straggler: its own deadline expired asleep
            assert res["syncB_elapsed_s"] >= sw.STRAGGLE_S - 0.5
            continue
        assert res["syncB_elapsed_s"] < sw.TIMEOUT_S + 30.0
        if action == "delay":  # a straggler's peers wait out the whole deadline
            assert res["syncB_elapsed_s"] >= sw.TIMEOUT_S - 0.5
        assert res["timeouts_local"] == 1.0


def test_per_tenant_obs_and_health_snapshots_written(world):
    action, outdir, _, _, _ = world
    for r in _survivors(action):
        with open(os.path.join(outdir, f"rank{r}.obs.json")) as f:
            counters = json.load(f)["counters"]
        assert any(k.startswith("serve.ingest.batches{") for k in counters)
        if r == sw.POISON_RANK:
            assert counters.get("serve.quarantines{reason=nan_policy,tenant=bob}") == 1.0
        with open(os.path.join(outdir, f"rank{r}.health.json")) as f:
            assert "alice" in json.load(f)["tenants"]
