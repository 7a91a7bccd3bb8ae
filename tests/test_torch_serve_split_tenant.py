"""Hot-tenant splitting on the CPU: one tenant's stream sharded across
hosts as replica tenants, each with its own seq namespace, merged back at
``compute()`` on the router's device (``device="cpu"`` here).

Counterpart: ``tests/serve/test_split_tenant.py``; the merged values are
bit-identical to one stream, through a replica host's death included.
Beyond the JAX file:

* the same batches through a JAX router over JAX hosts give the same
  merged values (the fan-out draw is the same hash, so each replica sees
  the same batches in both packages); accuracy and sliced values exactly
  as the JAX file holds them within its package;
* the kernel-bearing members of the card's split leg at small sizes —
  macro accuracy and F1 (the histogram), a compacting ``BinaryAUROC``
  (the compaction), ``BinaryAUROC`` under ``approx=True`` (the segment
  sum) and ``TopKMultilabelAccuracy(k=5)`` (the top-k) — split by 2 and
  held to the same members fed directly: accuracy exactly, F1 and AUROC
  within rtol 1e-5.
"""

import numpy as np
import pytest

import torcheval_tpu.serve as jserve
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.metrics import (
    BinaryAccuracy,
    BinaryAUROC,
    MulticlassAccuracy,
    MulticlassF1Score,
    TopKMultilabelAccuracy,
)
from torcheval_tpu_torch.serve import EvalDaemon, ServeError
from torcheval_tpu_torch.utils.test_utils import obs_counts
from torcheval_tpu_torch.utils.test_utils.router_fleet import (
    ROUTER_KW,
    SPEC,
    Fleet,
    acc,
    batch,
    oracle,
)

SLICED_SPEC = {"acc": ["BinaryAccuracy", {}], "auroc": ["BinaryAUROC", {}]}
SLICED_KNOBS = dict(approx=1024, slices={"capacity": 4})


def _sliced_batches(seed=0, n_batches=6, n=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        ids = rng.integers(0, 9, n).astype(np.int64) * 13 - 5
        s = rng.random(n).astype(np.float32)
        t = (rng.random(n) < 0.4).astype(np.float32)
        out.append((ids, s, t))
    return out


def _sliced_want(batches):
    with EvalDaemon(device="cpu") as local:
        h = local.attach(
            "ref", {"acc": BinaryAccuracy(device="cpu"), "auroc": BinaryAUROC(device="cpu")},
            **SLICED_KNOBS,
        )
        for b in batches:
            h.submit(*b)
        return h.compute()


def _per_cohort_equal(got, want):
    """Cohorts register in arrival order per replica, so both results are
    aligned by slice id; then every value matches exactly."""
    for key in ("acc", "auroc"):
        g_ids, w_ids = np.asarray(got[key]["slice_ids"]), np.asarray(want[key]["slice_ids"])
        np.testing.assert_array_equal(np.sort(g_ids), np.sort(w_ids))
        np.testing.assert_array_equal(
            np.asarray(got[key]["values"])[np.argsort(g_ids)],
            np.asarray(want[key]["values"])[np.argsort(w_ids)],
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
    f.r = f.router()
    yield f
    f.close()


# --- mechanics --------------------------------------------------------------

@pytest.mark.parametrize("bad", [1, 0, -2, True, 2.0])
def test_split_validation(fleet, bad):
    fleet.r.attach("ten", SPEC)
    with pytest.raises(ValueError):
        fleet.r.split_tenant("ten", replicas=bad)


def test_split_twice_or_of_a_replica_refused(fleet):
    fleet.r.attach("ten", SPEC)
    fleet.r.split_tenant("ten", replicas=2)
    for tid in ("ten", "ten@r1"):
        with pytest.raises(ServeError) as e:
            fleet.r.split_tenant(tid, replicas=2)
        assert e.value.reason == "split_tenant"


def test_split_spreads_replicas_and_counts(fleet, obs_on):
    fleet.r.attach("ten", SPEC)
    placed = fleet.r.split_tenant("ten", replicas=3)
    assert sorted(placed) == ["ten", "ten@r1", "ten@r2"]
    assert len(set(placed.values())) == 3
    assert obs_counts.count("serve.router.splits", tenant="ten") == 1


def test_fan_out_reaches_every_replica(fleet):
    fleet.r.attach("ten", SPEC)
    placed = fleet.r.split_tenant("ten", replicas=3)
    for i in range(30):
        fleet.r.submit("ten", *batch(i))
    fleet.r.flush("ten")
    processed = {
        rid: fleet.daemon_for(ep).health()["tenants"][rid]["processed"] for rid, ep in placed.items()
    }
    assert sum(processed.values()) == 30
    assert all(n > 0 for n in processed.values()), processed


def test_fan_out_draw_is_the_jax_routers(fleet):
    """The replica of the k-th batch is sha256("tid#k") mod n, as in JAX."""
    import hashlib

    fleet.r.attach("ten", SPEC)
    placed = fleet.r.split_tenant("ten", replicas=3)
    reps = fleet.r._tenants["ten"].replicas
    want = {rid: 0 for rid in placed}
    for k in range(30):
        d = hashlib.sha256(f"ten#{k}".encode()).digest()
        want[reps[int.from_bytes(d[:8], "big") % 3]] += 1
        fleet.r.submit("ten", *batch(k))
    fleet.r.flush("ten")
    got = {rid: fleet.daemon_for(ep).health()["tenants"][rid]["processed"] for rid, ep in placed.items()}
    assert got == want


def test_flush_and_detach_cover_all_replicas(fleet):
    fleet.r.attach("ten", SPEC)
    placed = fleet.r.split_tenant("ten", replicas=2)
    for i in range(6):
        fleet.r.submit("ten", *batch(i))
    flushed = fleet.r.flush("ten")
    assert sorted(flushed) == sorted(placed)
    assert all("path" in out for out in flushed.values())
    fleet.r.detach("ten")
    assert fleet.r.placement() == {}
    with pytest.raises(ServeError):
        fleet.r.compute("ten")


def test_more_replicas_than_hosts_still_splits(fleet):
    fleet.r.attach("ten", SPEC)
    assert len(fleet.r.split_tenant("ten", replicas=5)) == 5
    batches = [batch(i) for i in range(10)]
    for b in batches:
        fleet.r.submit("ten", *b)
    assert acc(fleet.r.compute("ten")) == oracle(batches)


# --- merged compute ---------------------------------------------------------

def test_merged_compute_matches_single_stream_oracle(fleet):
    fleet.r.attach("ten", SPEC)
    fleet.r.split_tenant("ten", replicas=3)
    batches = [batch(i) for i in range(24)]
    for b in batches:
        fleet.r.submit("ten", *b)
    got = acc(fleet.r.compute("ten"))
    assert got == oracle(batches)
    assert acc(fleet.r.compute("ten")) == got  # repeatable


def test_split_sliced_tenant_merges_bit_identical(fleet):
    batches = _sliced_batches(seed=7)
    want = _sliced_want(batches)
    fleet.r.attach("ten", SLICED_SPEC, **SLICED_KNOBS)
    fleet.r.split_tenant("ten", replicas=3)
    for b in batches:
        fleet.r.submit("ten", *b)
    _per_cohort_equal(fleet.r.compute("ten"), want)


# --- a replica's host dies --------------------------------------------------

def test_replica_host_killed_mid_stream_stays_exactly_once(fleet, obs_on):
    fleet.r.attach("ten", SPEC)
    placed = fleet.r.split_tenant("ten", replicas=2)
    batches = [batch(i) for i in range(12)]
    for b in batches[:6]:
        fleet.r.submit("ten", *b)
    fleet.r.flush("ten")
    for b in batches[6:9]:
        fleet.r.submit("ten", *b)  # un-durable tails
    victim = placed["ten@r1"]
    fleet.kill(victim)
    for b in batches[9:]:
        fleet.r.submit("ten", *b)
    assert acc(fleet.r.compute("ten")) == oracle(batches)
    placement = fleet.r.placement()
    assert placement["ten@r1"] != victim
    for rid, ep in placement.items():
        assert fleet.daemon_for(ep).health()["tenants"][rid]["dupes"] == 0, rid
    assert obs_counts.count("serve.router.migrations") == 1


def test_sliced_split_survives_replica_death_bit_identical(fleet):
    batches = _sliced_batches(seed=11, n_batches=9)
    want = _sliced_want(batches)
    fleet.r.attach("ten", SLICED_SPEC, **SLICED_KNOBS)
    placed = fleet.r.split_tenant("ten", replicas=2)
    for b in batches[:4]:
        fleet.r.submit("ten", *b)
    fleet.r.flush("ten")
    for b in batches[4:6]:
        fleet.r.submit("ten", *b)
    fleet.kill(placed["ten@r1"])
    for b in batches[6:]:
        fleet.r.submit("ten", *b)
    _per_cohort_equal(fleet.r.compute("ten"), want)
    assert fleet.r.placement()["ten@r1"] != placed["ten@r1"]


# --- the JAX router on the same batches -------------------------------------

@pytest.fixture
def jax_fleet(tmp_path):
    root = str(tmp_path / "jax_ckpt")
    daemons = [jserve.EvalDaemon(evict_dir=root).start() for _ in range(3)]
    servers = [jserve.EvalServer(d) for d in daemons]
    router = jserve.EvalRouter([s.endpoint for s in servers], **ROUTER_KW)
    yield router
    router.close()
    for s, d in zip(servers, daemons):
        s.close()
        d.stop()


@pytest.mark.parametrize("replicas", [2, 3])
def test_merged_accuracy_equals_the_jax_routers(fleet, jax_fleet, replicas):
    batches = [batch(i, n=16) for i in range(20)]
    for r in (fleet.r, jax_fleet):
        r.attach("ten", SPEC)
        r.split_tenant("ten", replicas=replicas)
        for b in batches:
            r.submit("ten", *b)
    got, want = acc(fleet.r.compute("ten")), acc(jax_fleet.compute("ten"))
    assert np.float32(got).tobytes() == np.float32(want).tobytes()


def test_merged_sliced_values_equal_the_jax_routers(fleet, jax_fleet):
    batches = _sliced_batches(seed=5, n_batches=8)
    for r in (fleet.r, jax_fleet):
        r.attach("ten", SLICED_SPEC, **SLICED_KNOBS)
        r.split_tenant("ten", replicas=2)
        for b in batches:
            r.submit("ten", *b)
    got, want = fleet.r.compute("ten"), jax_fleet.compute("ten")
    for key in ("acc", "auroc"):
        g_ids, w_ids = np.asarray(got[key]["slice_ids"]), np.asarray(want[key]["slice_ids"])
        np.testing.assert_array_equal(np.sort(g_ids), np.sort(w_ids))
        np.testing.assert_allclose(
            np.asarray(got[key]["values"], np.float64)[np.argsort(g_ids)],
            np.asarray(want[key]["values"], np.float64)[np.argsort(w_ids)],
            rtol=1e-5, atol=1e-8,
        )


# --- the kernel-bearing members --------------------------------------------

C = 40
K = 5


def _kernel_case(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "macro":
        spec = {"acc": ["MulticlassAccuracy", {"num_classes": C, "average": "macro"}],
                "f1": ["MulticlassF1Score", {"num_classes": C, "average": "macro"}]}
        members = lambda: {"acc": MulticlassAccuracy(num_classes=C, average="macro", device="cpu"),  # noqa: E731
                           "f1": MulticlassF1Score(num_classes=C, average="macro", device="cpu")}
        batches = [(rng.random((64, C), dtype=np.float32), rng.integers(0, C, 64)) for _ in range(8)]
        return spec, members, batches, {}
    if kind in ("compact", "approx"):
        kw = {"compaction_threshold": 100} if kind == "compact" else {}
        spec = {"auroc": ["BinaryAUROC", kw]}
        members = lambda: {"auroc": BinaryAUROC(device="cpu", **kw)}  # noqa: E731
        batches = [(rng.integers(0, 50, 96).astype(np.float32) / 49,
                    (rng.random(96) < 0.4).astype(np.float32)) for _ in range(8)]
        return spec, members, batches, ({"approx": True} if kind == "approx" else {})
    spec = {"acc": ["TopKMultilabelAccuracy", {"k": K, "criteria": "contain"}]}
    members = lambda: {"acc": TopKMultilabelAccuracy(k=K, criteria="contain", device="cpu")}  # noqa: E731
    batches = [(rng.random((32, 60), dtype=np.float32), (rng.random((32, 60)) < 0.05).astype(np.float32))
               for _ in range(8)]
    return spec, members, batches, {}


@pytest.mark.parametrize("kind", ["macro", "compact", "approx", "topk"])
def test_kernel_members_split_equal_the_direct_fold(fleet, kind):
    spec, members, batches, knobs = _kernel_case(kind, seed=300)
    fleet.r.attach("ten", spec, **knobs)
    fleet.r.split_tenant("ten", replicas=2)
    for b in batches:
        fleet.r.submit("ten", *b)
    got = fleet.r.compute("ten")
    with EvalDaemon(device="cpu") as local:
        h = local.attach("ref", members(), **knobs)
        for b in batches:
            h.submit(*b)
        want = h.compute()
    for name in want:
        g, w = np.asarray(got[name], np.float64), np.asarray(want[name], np.float64)
        if name == "acc":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)


@pytest.mark.parametrize("kind", ["macro", "compact", "topk"])
def test_kernel_members_split_equal_the_jax_routers(fleet, jax_fleet, kind):
    spec, _, batches, knobs = _kernel_case(kind, seed=301)
    for r in (fleet.r, jax_fleet):
        r.attach("ten", spec, **knobs)
        r.split_tenant("ten", replicas=2)
        for b in batches:
            r.submit("ten", *b)
    got, want = fleet.r.compute("ten"), jax_fleet.compute("ten")
    for name in want:
        g, w = np.asarray(got[name], np.float64), np.asarray(want[name], np.float64)
        if name == "acc":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
