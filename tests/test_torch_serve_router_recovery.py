"""Router crash recovery from the control-plane journal, on the CPU.

Counterpart: ``tests/serve/test_router_recovery.py``: every
reconciliation outcome of the recovery pass — adopt in place (a split
tenant's fan-out ordinal re-derived from replica watermarks included),
re-place off a dead host from its checkpoint, orphan adoption, stale
double-attach resolution, torn-split rollback, drain persistence, a
runtime host re-minted — and the corrupt-newest-checkpoint drill
(``ckpt_corrupt`` chaos, lineage fallback). Every streaming case ends
bit-identical to a one-stream oracle with zero duplicate application.
Three in-process hosts on one checkpoint root
(``utils/test_utils/router_fleet.py``).

Beyond the JAX file: a journal written by the JAX router recovers a port
router over the same hosts, and the reverse.
"""

import glob
import os

import pytest

import torcheval_tpu.serve as jserve
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.resilience import chaos
from torcheval_tpu_torch.serve.journal import RouterJournal
from torcheval_tpu_torch.utils.test_utils import obs_counts
from torcheval_tpu_torch.utils.test_utils.router_fleet import (
    ROUTER_KW,
    SPEC,
    Fleet,
    acc,
    batch,
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
    f = Fleet(str(tmp_path / "ckpt"), 3)
    f.journal_dir = str(tmp_path / "journal")
    yield f
    f.close()


def _router(fleet, *, journal=True, endpoints=None):
    return fleet.router(endpoints, journal_dir=fleet.journal_dir if journal else None)


# --- adopt ------------------------------------------------------------------

def test_adoption_preserves_placement_and_bit_identity(fleet, obs_on):
    batches = [batch(i) for i in range(24)]
    r1 = _router(fleet)
    r1.attach("solo", SPEC)
    r1.attach("fan", SPEC)
    r1.split_tenant("fan", replicas=3)
    for b in batches[:12]:
        r1.submit("solo", *b)
        r1.submit("fan", *b)
    r1.flush("solo")
    r1.flush("fan")
    placement_before = r1.placement()
    r1.close()  # the crash: routing table and client cursors gone

    r2 = _router(fleet)
    assert r2.last_recovery["outcomes"] == {"adopted": 4}
    assert r2.placement() == placement_before
    assert r2._tenants["fan"].split_next == 12  # the sum of replica watermarks
    for b in batches[12:]:
        r2.submit("solo", *b)
        r2.submit("fan", *b)
    want = oracle(batches)
    assert acc(r2.compute("solo")) == want
    assert acc(r2.compute("fan")) == want
    assert fleet.total_dupes() == 0
    assert obs_counts.count("serve.router.recoveries", outcome="adopted") == 4
    assert obs_counts.count("serve.router.journal_compactions") >= 1


def test_blackout_is_measured_and_bounded(fleet):
    r1 = _router(fleet)
    r1.attach("ten", SPEC)
    r1.close()
    rec = _router(fleet).last_recovery
    assert 0.0 < rec["duration_s"] < 30.0
    assert rec["tenants"] == 1
    assert sorted(rec["alive"]) == sorted(fleet.endpoints)
    # r1's cold start compacted an empty table; its one place record follows
    assert rec["journal_records"] == 1


def test_journal_less_router_has_no_recovery(fleet):
    assert _router(fleet, journal=False).last_recovery is None


# --- re-place ---------------------------------------------------------------

def test_dead_host_tenant_replaced_from_checkpoint(fleet, obs_on):
    batches = [batch(i) for i in range(16)]
    r1 = _router(fleet)
    victim_ep = r1.attach("vic", SPEC)
    for b in batches[:8]:
        r1.submit("vic", *b)
    r1.flush("vic")  # durable watermark: seq 8
    r1.close()
    fleet.kill(victim_ep)

    r2 = _router(fleet)
    assert r2.last_recovery["outcomes"] == {"replaced": 1}
    new_ep = r2.placement()["vic"]
    assert new_ep != victim_ep
    assert r2._clients[new_ep]._tenants["vic"].durable_seq == 8
    for b in batches[8:]:
        r2.submit("vic", *b)
    assert acc(r2.compute("vic")) == oracle(batches)
    assert fleet.total_dupes() == 0
    assert obs_counts.count("serve.router.recoveries", outcome="replaced") == 1


def test_unplaceable_tenant_is_dropped_not_fatal(fleet):
    r1 = _router(fleet)
    r1.attach("ten", SPEC)  # never flushed: no checkpoint anywhere
    victim_ep = r1.placement()["ten"]
    r1.close()
    fleet.kill(victim_ep)
    r2 = _router(fleet)
    assert list(r2.last_recovery["outcomes"]) in (["replaced"], ["dropped"])


# --- orphans and stale copies -----------------------------------------------

def test_live_unjournaled_tenant_is_adopted_with_its_spec(fleet, obs_on):
    batches = [batch(i) for i in range(10)]
    r0 = _router(fleet, journal=False)
    r0.attach("ghost", SPEC)
    for b in batches[:5]:
        r0.submit("ghost", *b)
    r0.flush("ghost")
    r0.close()

    r2 = _router(fleet)  # the journal is empty: "ghost" is an orphan
    assert r2.last_recovery["outcomes"] == {"orphan_adopted": 1}
    for b in batches[5:]:
        r2.submit("ghost", *b)
    assert acc(r2.compute("ghost")) == oracle(batches)
    assert fleet.total_dupes() == 0


def test_double_attached_tenant_keeps_the_advanced_copy(fleet):
    r1 = _router(fleet)
    ep_new = r1.attach("twin", SPEC)
    for i in range(6):
        r1.submit("twin", *batch(i))
    r1.flush("twin")
    # the stale copy, behind by construction (resume="never": it must not
    # restore the advanced copy's checkpoint from the shared root)
    ep_stale = next(e for e in fleet.endpoints if e != ep_new)
    stale_client = r1._clients[ep_stale]
    stale_client.attach("twin", SPEC, resume="never")
    stale_client.submit("twin", *batch(0))
    stale_client.flush("twin")
    r1.close()

    r2 = _router(fleet)
    outcomes = r2.last_recovery["outcomes"]
    assert outcomes.get("stale_dropped") == 1
    assert outcomes.get("adopted") == 1
    assert r2.placement()["twin"] == ep_new
    assert "twin" not in fleet.daemon_for(ep_stale).health()["tenants"]


def test_torn_split_replica_rolled_back(fleet):
    r0 = _router(fleet, journal=False)
    r0.attach("ten", SPEC)
    r0.attach("ten@r1", SPEC)
    ep_parent = r0.placement()["ten"]
    ep_replica = r0.placement()["ten@r1"]
    r0.close()
    j = RouterJournal(fleet.journal_dir)
    j.append("place", tenant="ten", endpoint=ep_parent, spec=SPEC, knobs={}, parent=None)
    j.append("place", tenant="ten@r1", endpoint=ep_replica, spec=SPEC, knobs={}, parent="ten")
    j.close()  # and no "split" record: the crash hit between the two

    r2 = _router(fleet)
    outcomes = r2.last_recovery["outcomes"]
    assert outcomes.get("split_rolled_back") == 1
    assert outcomes.get("adopted") == 1
    assert list(r2.placement()) == ["ten"]
    assert "ten@r1" not in fleet.daemon_for(ep_replica).health()["tenants"]


# --- drains and hosts -------------------------------------------------------

def test_explicit_drain_survives_recovery(fleet):
    r1 = _router(fleet)
    r1.attach("ten", SPEC)
    drained_ep = next(e for e in fleet.endpoints if e != r1.placement()["ten"])
    r1.drain(drained_ep)
    r1.close()
    r2 = _router(fleet)
    assert r2.last_recovery["drained"] == [drained_ep]
    assert drained_ep not in r2.alive
    for i in range(6):
        assert r2.attach(f"t{i}", SPEC) != drained_ep


def test_runtime_added_host_is_reminted_at_recovery(fleet):
    extra = fleet.start_host()
    r1 = _router(fleet, endpoints=fleet.endpoints[:1])
    r1.add_host(extra)
    r1.close()
    r2 = _router(fleet, endpoints=fleet.endpoints[:1])
    assert extra in r2.endpoints and extra in r2.alive


def test_removed_host_stays_forgotten(fleet):
    r1 = _router(fleet)
    gone = fleet.endpoints[2]
    r1.remove_host(gone)
    r1.close()
    r2 = _router(fleet, endpoints=fleet.endpoints[:2])
    assert gone not in r2.endpoints


# --- the corrupt newest checkpoint ------------------------------------------

def test_corrupt_newest_falls_back_and_replay_heals(fleet, obs_on, monkeypatch):
    batches = [batch(i) for i in range(16)]
    for k, v in {
        "TORCHEVAL_TPU_CHAOS": "1",
        "TORCHEVAL_TPU_CHAOS_ACTION": "ckpt_corrupt",
        "TORCHEVAL_TPU_CHAOS_TENANT": "/vic/",
        "TORCHEVAL_TPU_CHAOS_STEP": "2",
    }.items():
        monkeypatch.setenv(k, v)
    chaos.reset_for_tests()
    try:
        r1 = _router(fleet)
        victim_ep = r1.attach("vic", SPEC)
        for b in batches[:8]:
            r1.submit("vic", *b)
        r1.flush("vic")  # generation 1: intact
        for b in batches[8:12]:
            r1.submit("vic", *b)
        r1.flush("vic")  # generation 2: chaos flips one payload byte
        r1.close()
        fleet.kill(victim_ep)
        r2 = _router(fleet)
    finally:
        for k in list(os.environ):
            if k.startswith("TORCHEVAL_TPU_CHAOS"):
                monkeypatch.delenv(k)
        chaos.reset_for_tests()
    assert r2.last_recovery["outcomes"] == {"replaced": 1}
    new_ep = r2.placement()["vic"]
    assert r2._clients[new_ep]._tenants["vic"].durable_seq == 8  # generation 1's
    for b in batches[8:]:
        r2.submit("vic", *b)
    assert acc(r2.compute("vic")) == oracle(batches)
    assert fleet.total_dupes() == 0
    assert len(glob.glob(os.path.join(fleet.root, "vic", "corrupt-ckpt-*"))) == 1
    assert obs_counts.count("resilience.checkpoint.corrupt_quarantined") == 1
    assert obs_counts.count("resilience.checkpoint.fallback_restores") >= 1


# --- across the packages ----------------------------------------------------

@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_journal_recovers_the_other_packages_router(fleet, first):
    """Both routers front the same port hosts over TCP; the first writes
    the journal (a plain tenant, a split one, a drained host), the other
    recovers from it and finishes the streams."""
    def make(pkg):
        if pkg == "port":
            return _router(fleet)
        r = jserve.EvalRouter(fleet.endpoints, journal_dir=fleet.journal_dir, **ROUTER_KW)
        fleet.routers.append(r)
        return r

    fleet.start_host()  # four hosts for three tenants: one is always spare
    batches = [batch(i) for i in range(12)]
    r1 = make(first)
    r1.attach("solo", SPEC)
    r1.attach("fan", SPEC)
    r1.split_tenant("fan", replicas=2)
    for b in batches[:6]:
        r1.submit("solo", *b)
        r1.submit("fan", *b)
    r1.flush("solo")
    r1.flush("fan")
    placement = r1.placement()
    spare = next(e for e in fleet.endpoints if e not in placement.values())
    r1.drain(spare)
    r1.close()

    r2 = make("jax" if first == "port" else "port")
    assert r2.last_recovery["outcomes"] == {"adopted": 3}
    assert r2.last_recovery["drained"] == [spare]
    assert r2.placement() == placement
    for b in batches[6:]:
        r2.submit("solo", *b)
        r2.submit("fan", *b)
    want = oracle(batches)
    assert acc(r2.compute("solo")) == want
    # the JAX router merges the port hosts' checkpoints in the JAX package
    assert acc(r2.compute("fan")) == want
    assert fleet.total_dupes() == 0
