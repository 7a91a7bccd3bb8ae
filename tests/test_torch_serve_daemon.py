"""The port's ``EvalDaemon`` against the JAX package's on the CPU.

Counterparts: ``tests/serve/test_daemon.py``, ``test_coalescing.py``,
``test_fault_containment.py``, ``test_queue_depth.py``,
``test_load_report.py``, ``test_slo_breach.py``, ``test_approx_knob.py``
and ``test_sliced_serve.py``. The same seeded numpy streams go through a
JAX ``EvalDaemon`` and a port ``EvalDaemon(device="cpu")``: served values
equal the port's own direct collection bit for bit and the JAX daemon's
within rtol 1e-5 / atol 1e-8 (counts exactly); refusals carry the same
reasons; the per-tenant ``serve.*`` counters of one scenario are equal in
both registries.
"""

import json
import os
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as jm
import torcheval_tpu.serve as js
import torcheval_tpu_torch.metrics as tm
import torcheval_tpu_torch.serve as ts
from torcheval_tpu import obs as jobs
from torcheval_tpu.resilience import chaos as jchaos
from torcheval_tpu_torch import obs as tobs
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.obs import registry as treg
from torcheval_tpu_torch.obs import slo as tslo
from torcheval_tpu_torch.resilience import chaos as tchaos

C = 5


def _batches(n_batches, seed, n=32, c=C):
    rng = np.random.default_rng(seed)
    return [
        (rng.random((n, c)).astype(np.float32), rng.integers(0, c, n))
        for _ in range(n_batches)
    ]


def _tdaemon(**kw):
    return ts.EvalDaemon(device="cpu", **kw)


def _tacc(c=C):
    return tm.MulticlassAccuracy(num_classes=c, device="cpu")


def _port_oracle(batches, c=C):
    m = _tacc(c)
    for s, l in batches:
        m.update(s, l)
    return m.compute()


def _jax_oracle(batches, c=C):
    m = jm.MulticlassAccuracy(num_classes=c)
    for s, l in batches:
        m.update(s, l)
    return m.compute()


def _bits(x):
    return np.asarray(x).tobytes()


def _close(port, jax):
    np.testing.assert_allclose(
        np.asarray(port, dtype=np.float64), np.asarray(jax, dtype=np.float64), rtol=1e-5, atol=1e-8
    )


@pytest.fixture
def both_obs():
    """Both packages' registries on and empty (each package has its own)."""
    for o in (jobs, tobs):
        o.reset()
        o.enable()
    yield
    for o in (jobs, tobs):
        o.disable()
        o.reset()


class _ChaosEnv:
    """Arm chaos in BOTH packages through the environment for one block."""

    def __init__(self, **env):
        self.env = {k: str(v) for k, v in env.items()}

    def __enter__(self):
        self._patch = mock.patch.dict(os.environ, self.env)
        self._patch.__enter__()
        jchaos.reset_for_tests()
        tchaos.reset_for_tests()

    def __exit__(self, *exc):
        self._patch.__exit__(*exc)
        jchaos.reset_for_tests()
        tchaos.reset_for_tests()


class GateMetric(Metric):
    """Eager metric whose update blocks on an event: wedges the worker."""

    def __init__(self, gate, started=None, *, device="cpu"):
        super().__init__(device=device)
        self.gate = gate
        self.started = started

    def update(self, *args):
        if self.started is not None:
            self.started.set()
        self.gate.wait(30)
        return self

    def compute(self):
        return 0.0

    def merge_state(self, metrics):
        return self


class RaisingComputeMetric(Metric):
    def __init__(self):
        super().__init__(device="cpu")

    def update(self, *args):
        return self

    def compute(self):
        raise RuntimeError("tenant compute exploded")

    def merge_state(self, metrics):
        return self


# ------------------------------------------------------------ lifecycle
def test_compute_matches_plain_collection_and_the_jax_daemon():
    batches = _batches(12, seed=0)

    def members(M, **kw):
        return {
            "acc": M.MulticlassAccuracy(num_classes=C, **kw),
            "f1": M.MulticlassF1Score(num_classes=C, average="macro", **kw),
        }

    oracle = tm.MetricCollection(members(tm, device="cpu"))
    for s, l in batches:
        oracle.update(s, l)
    want = oracle.compute()
    with _tdaemon() as daemon:
        h = daemon.attach("parity", members(tm, device="cpu"))
        for s, l in batches:
            h.submit(s, l)
        got = h.compute(timeout=60)
    with js.EvalDaemon() as jd:
        jh = jd.attach("parity", members(jm))
        for s, l in batches:
            jh.submit(s, l)
        jgot = jh.compute(timeout=60)
    for k in want:
        assert _bits(got[k]) == _bits(want[k])
        _close(got[k], jgot[k])


def test_compute_then_more_batches_then_compute():
    with _tdaemon() as daemon, js.EvalDaemon() as jd:
        h = daemon.attach("t", _tacc())
        jh = jd.attach("t", jm.MulticlassAccuracy(num_classes=C))
        oracle = _tacc()
        for lo, hi in ((0, 3), (3, 6)):
            for seed in range(lo, hi):
                s, l = _batches(1, seed)[0]
                h.submit(s, l)
                jh.submit(s, l)
                oracle.update(s, l)
            got = h.compute(timeout=60)
            assert _bits(got) == _bits(oracle.compute())
            _close(got, jh.compute(timeout=60))


def test_detach_frees_slot_and_handle_dies():
    with _tdaemon(max_tenants=1) as daemon:
        h = daemon.attach("a", _tacc())
        h.submit(*_batches(1, 1)[0])
        assert h.detach(timeout=60) is None
        assert h.status is ts.TenantStatus.DETACHED
        with pytest.raises(ts.ServeError):
            h.submit(*_batches(1, 1)[0])
        assert daemon.attach("b", _tacc()).status is ts.TenantStatus.ACTIVE


def test_prebuilt_collection_accepted():
    with _tdaemon() as daemon:
        h = daemon.attach("pre", tm.MetricCollection({"acc": _tacc()}))
        h.submit(*_batches(1, 2)[0])
        assert "acc" in h.compute(timeout=60)


def test_health_snapshot_equals_the_jax_daemons():
    def run(daemon, acc):
        with daemon as d:
            h = d.attach("h1", acc)
            h.submit(*_batches(1, 3)[0])
            h.compute(timeout=60)
            return d.health()

    got = run(_tdaemon(max_tenants=3), _tacc())
    want = run(js.EvalDaemon(max_tenants=3), jm.MulticlassAccuracy(num_classes=C))
    assert got["worker_alive"] and want["worker_alive"]
    assert got["capacity"] == want["capacity"] == {"max_tenants": 3, "active_tenants": 1}
    assert got["totals"] == want["totals"]
    keys = ("status", "queue_depth", "queue_capacity", "ingested", "processed", "sheds", "dupes")
    assert {k: got["tenants"]["h1"][k] for k in keys} == {k: want["tenants"]["h1"][k] for k in keys}
    assert got["tenants"]["h1"]["processed"] == 1
    assert set(got) == set(want)


def test_the_daemon_serves_cuda_by_default_and_refuses_other_devices():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ts.EvalDaemon()
    with _tdaemon() as daemon:
        assert daemon.device == torch.device("cpu")
        with pytest.raises(ts.AdmissionError) as ctx:
            daemon.attach("x", tm.MulticlassAccuracy(num_classes=C, device="meta"))
        assert ctx.value.reason == "bad_metrics"
        # a refused attach leaves no tenant and no reservation behind
        daemon.attach("x", _tacc())


# ------------------------------------------------------------ admission
def _admission_reason(pkg, scenario):
    M = tm if pkg == "torch" else jm
    kw = {"device": "cpu"} if pkg == "torch" else {}
    S = ts if pkg == "torch" else js
    acc = lambda: M.MulticlassAccuracy(num_classes=C, **kw)  # noqa: E731
    if scenario == "daemon_stopped":
        with pytest.raises(S.AdmissionError) as ctx:
            S.EvalDaemon(**kw).attach("x", acc())
        return ctx.value.reason
    with S.EvalDaemon(max_tenants=2, **kw) as daemon:
        with pytest.raises(S.AdmissionError) as ctx:
            if scenario == "duplicate_tenant":
                daemon.attach("dup", acc())
                daemon.attach("dup", acc())
            elif scenario == "capacity":
                daemon.attach("a", acc())
                daemon.attach("b", acc())
                daemon.attach("c", acc())
            elif scenario == "bad_metrics":
                daemon.attach("bad", {})
            elif scenario == "no_checkpoint":
                daemon.attach("ghost", acc(), resume="require")
        return ctx.value.reason


@pytest.mark.parametrize(
    "scenario", ["duplicate_tenant", "capacity", "daemon_stopped", "bad_metrics", "no_checkpoint"]
)
def test_admission_refusals_carry_the_jax_reasons(scenario):
    assert _admission_reason("torch", scenario) == _admission_reason("jax", scenario) == scenario


def test_bad_knobs_raise_valueerror():
    with pytest.raises(ValueError):
        _tdaemon(max_tenants=0)
    with pytest.raises(ValueError):
        _tdaemon(queue_capacity=0)
    with _tdaemon() as daemon:
        with pytest.raises(ValueError):
            daemon.attach("x", _tacc(), nan_policy="drop")
        with pytest.raises(ValueError):
            daemon.attach("x", _tacc(), resume="maybe")
        for knob in ("watchdog_timeout_s", "step_timeout_s"):
            for bad in (0, -1.0, float("nan"), float("inf")):
                with pytest.raises(ValueError, match=knob):
                    daemon.attach("x", _tacc(), **{knob: bad})
        for bad in (0, -1):
            with pytest.raises(ValueError, match="queue_capacity"):
                daemon.attach("x", _tacc(), queue_capacity=bad)
        h = daemon.attach("x", _tacc(), queue_capacity=1)
        assert h._tenant.capacity == 1


def test_full_queue_sheds_with_reason_and_block_waits():
    gate, started = threading.Event(), threading.Event()
    try:
        with _tdaemon() as daemon:
            h = daemon.attach("bp", {"gate": GateMetric(gate, started)}, queue_capacity=2)
            h.submit(np.float32([1.0]))
            assert started.wait(10)
            h.submit(np.float32([2.0]))
            h.submit(np.float32([3.0]))
            with pytest.raises(ts.BackpressureError) as ctx:
                h.submit(np.float32([4.0]))
            assert (ctx.value.reason, ctx.value.tenant) == ("queue_full", "bp")
            t0 = time.monotonic()
            with pytest.raises(ts.BackpressureError):
                h.submit(np.float32([5.0]), block=True, timeout=0.3)
            assert time.monotonic() - t0 >= 0.25
            box = {}

            def _blocked_submit():
                h.submit(np.float32([6.0]), block=True, timeout=20)
                box["ok"] = True

            t = threading.Thread(target=_blocked_submit)
            t.start()
            gate.set()
            t.join(20)
            assert box.get("ok")
            assert daemon.health()["tenants"]["bp"]["sheds"] >= 2
    finally:
        gate.set()


# ----------------------------------------------------------- coalescing
def test_100_tenants_one_signature_equal_values_and_jax(both_obs):
    batches = _batches(3, seed=1, n=16)
    with _tdaemon(max_tenants=128) as daemon:
        handles = [daemon.attach(f"tenant-{i}", {f"m{i}": _tacc()}) for i in range(100)]
        for s, l in batches:
            for h in handles:
                h.submit(s, l)
        values = {_bits(h.compute(timeout=120)[f"m{i}"]) for i, h in enumerate(handles)}
    assert values == {_bits(_port_oracle(batches))}
    _close(_port_oracle(batches), _jax_oracle(batches))
    # the batches went through the coalesced staging pass
    assert tobs.snapshot()["counters"]["serve.ingest.h2d_bytes"] > 0


def test_canonical_mapping_lands_results_under_the_right_names():
    scores = np.float32([[0.9, 0.1], [0.2, 0.8]])
    labels = np.int64([0, 0])
    preds, target = np.float32([1.0, 0.0]), np.float32([1.0, 3.0])
    a = tm.MetricCollection(
        {"acc": tm.MulticlassAccuracy(num_classes=2, device="cpu"), "mse": tm.MeanSquaredError(device="cpu")}
    )
    b = tm.MetricCollection(
        {"mse": tm.MulticlassAccuracy(num_classes=2, device="cpu"), "acc": tm.MeanSquaredError(device="cpu")}
    )
    a.metrics["acc"].update(scores, labels)
    a.metrics["mse"].update(preds, target)
    b.metrics["mse"].update(scores, labels)
    b.metrics["acc"].update(preds, target)
    ra, rb = a.compute(), b.compute()
    assert float(ra["acc"]) == float(rb["mse"]) == 0.5
    assert float(ra["mse"]) == float(rb["acc"]) == 4.5


def test_mixed_signatures_fall_back_per_tenant():
    b16, b32 = _batches(3, seed=2, n=16), _batches(3, seed=3, n=32)
    with _tdaemon() as daemon:
        h16 = daemon.attach("t16", _tacc())
        h32 = daemon.attach("t32", _tacc())
        for (s16, l16), (s32, l32) in zip(b16, b32):
            h16.submit(s16, l16)
            h32.submit(s32, l32)
        assert _bits(h16.compute(timeout=60)) == _bits(_port_oracle(b16))
        assert _bits(h32.compute(timeout=60)) == _bits(_port_oracle(b32))


# -------------------------------------------------------- containment
def test_wrong_shape_batch_quarantines_only_that_tenant():
    healthy_batches = _batches(6, seed=0)
    with _tdaemon() as daemon:
        victim = daemon.attach("victim", _tacc())
        healthy = daemon.attach("healthy", _tacc())
        for i, (s, l) in enumerate(healthy_batches):
            healthy.submit(s, l)
            victim.submit(s, l[:-1] if i == 2 else l)
        with pytest.raises(ts.TenantQuarantinedError) as ctx:
            victim.compute(timeout=60)
        assert (ctx.value.reason, ctx.value.tenant) == ("poisoned_batch", "victim")
        assert isinstance(ctx.value.__cause__, ValueError)
        assert victim.status is ts.TenantStatus.QUARANTINED
        assert _bits(healthy.compute(timeout=60)) == _bits(_port_oracle(healthy_batches))
        assert daemon.health()["worker_alive"]
        with pytest.raises(ts.TenantQuarantinedError):
            victim.submit(*healthy_batches[0])


def test_nan_policy_reject_quarantines_and_propagate_contains():
    nan_scores = np.full((32, C), np.nan, dtype=np.float32)
    labels = np.zeros(32, dtype=np.int64)
    clean = _batches(3, seed=1)
    with _tdaemon() as daemon:
        strict = daemon.attach("strict", _tacc(), nan_policy="reject")
        lax_t = daemon.attach("lax", _tacc())
        bystander = daemon.attach("bystander", _tacc())
        for s, l in clean:
            bystander.submit(s, l)
        strict.submit(nan_scores, labels)
        lax_t.submit(nan_scores, labels)
        with pytest.raises(ts.TenantQuarantinedError) as ctx:
            strict.compute(timeout=60)
        assert ctx.value.reason == "nan_policy"
        assert np.isfinite(float(lax_t.compute(timeout=60)))
        assert lax_t.status is ts.TenantStatus.ACTIVE
        assert _bits(bystander.compute(timeout=60)) == _bits(_port_oracle(clean))
        # the NaN scan sees tensors too (an in-process caller's batch)
        t2 = daemon.attach("strict_tensor", _tacc(), nan_policy="reject")
        t2.submit(torch.from_numpy(nan_scores), torch.from_numpy(labels))
        with pytest.raises(ts.TenantQuarantinedError) as ctx:
            t2.compute(timeout=60)
        assert ctx.value.reason == "nan_policy"


def test_raising_compute_quarantines_with_cause():
    with _tdaemon() as daemon:
        bad = daemon.attach("bad", {"boom": RaisingComputeMetric()})
        ok = daemon.attach("ok", _tacc())
        batches = _batches(2, seed=2)
        for s, l in batches:
            ok.submit(s, l)
        bad.submit(np.float32([1.0]))
        with pytest.raises(ts.TenantQuarantinedError) as ctx:
            bad.compute(timeout=60)
        assert ctx.value.reason == "compute_error"
        assert isinstance(ctx.value.__cause__, RuntimeError)
        assert _bits(ok.compute(timeout=60)) == _bits(_port_oracle(batches))


def test_step_deadline_quarantines_stuck_tenant():
    gate = threading.Event()
    try:
        with _tdaemon() as daemon:
            stuck = daemon.attach("stuck", {"block": GateMetric(gate)}, step_timeout_s=0.5)
            ok = daemon.attach("ok", _tacc())
            batches = _batches(2, seed=3)
            t0 = time.monotonic()
            stuck.submit(np.float32([1.0]))
            for s, l in batches:
                ok.submit(s, l)
            with pytest.raises(ts.TenantQuarantinedError) as ctx:
                stuck.compute(timeout=60)
            assert ctx.value.reason == "step_timeout"
            assert time.monotonic() - t0 < 20.0
            assert _bits(ok.compute(timeout=60)) == _bits(_port_oracle(batches))
    finally:
        gate.set()


# ---------------------------------------------------- eviction / resume
def test_watchdog_evicts_idle_tenant_and_reattach_resumes_bit_identical(tmp_path):
    batches = _batches(8, seed=4)
    with _tdaemon(evict_dir=str(tmp_path), watchdog_interval_s=0.05) as daemon:
        h = daemon.attach("w", _tacc(), watchdog_timeout_s=0.3)
        for s, l in batches[:4]:
            h.submit(s, l)
        deadline = time.monotonic() + 30
        while h.status is ts.TenantStatus.ACTIVE and time.monotonic() < deadline:
            time.sleep(0.05)
        assert h.status is ts.TenantStatus.EVICTED
        err = h.error
        assert isinstance(err, ts.TenantEvictedError) and err.reason == "watchdog_idle"
        assert os.path.isdir(err.checkpoint)
        with pytest.raises(ts.TenantEvictedError):
            h.submit(*batches[4])
        h2 = daemon.attach("w", _tacc(), resume="require")
        for s, l in batches[4:]:
            h2.submit(s, l)
        assert _bits(h2.compute(timeout=60)) == _bits(_port_oracle(batches))


@pytest.mark.parametrize("how", ["evict", "detach_checkpoint"])
def test_explicit_eviction_roundtrip(tmp_path, how):
    batches = _batches(6, seed=5)
    with _tdaemon(evict_dir=str(tmp_path)) as daemon:
        h = daemon.attach("e", _tacc())
        for s, l in batches[:3]:
            h.submit(s, l)
        if how == "evict":
            path = daemon.evict("e", timeout=60)
            assert h.status is ts.TenantStatus.EVICTED and h.error.checkpoint == path
        else:
            path = h.detach(checkpoint=True, timeout=60)
        assert os.path.isdir(path)
        h2 = daemon.attach("e", _tacc(), resume="auto")
        for s, l in batches[3:]:
            h2.submit(s, l)
        assert _bits(h2.compute(timeout=60)) == _bits(_port_oracle(batches))


def test_resume_never_starts_clean(tmp_path):
    with _tdaemon(evict_dir=str(tmp_path)) as daemon:
        h = daemon.attach("c", _tacc())
        h.submit(*_batches(1, seed=7)[0])
        h.detach(checkpoint=True, timeout=60)
        fresh = _batches(2, seed=8)
        h2 = daemon.attach("c", _tacc(), resume="never")
        for s, l in fresh:
            h2.submit(s, l)
        assert _bits(h2.compute(timeout=60)) == _bits(_port_oracle(fresh))


def test_quarantined_state_is_never_checkpointed():
    with _tdaemon() as daemon:
        h = daemon.attach("q", _tacc())
        s, l = _batches(1, seed=9)[0]
        h.submit(s, l[:-1])
        with pytest.raises(ts.TenantQuarantinedError):
            h.compute(timeout=60)
        with pytest.raises(ts.ServeError):
            daemon.evict("q", timeout=60)


# ------------------------------------------------ chaos at the queue edge
@pytest.mark.parametrize(
    "poison,policy,step,reason",
    [("nan", "reject", 2, "nan_policy"), ("shape", "propagate", 1, "poisoned_batch")],
)
def test_chaos_poison_quarantines_target_tenant_only(poison, policy, step, reason):
    clean = _batches(4, seed=10)
    with _ChaosEnv(
        TORCHEVAL_TPU_CHAOS="1",
        TORCHEVAL_TPU_CHAOS_ACTION="poison",
        TORCHEVAL_TPU_CHAOS_TENANT="victim",
        TORCHEVAL_TPU_CHAOS_STEP=str(step),
        TORCHEVAL_TPU_CHAOS_POISON=poison,
    ):
        with _tdaemon() as daemon:
            victim = daemon.attach("victim", _tacc(), nan_policy=policy)
            other = daemon.attach("other", _tacc())
            for s, l in clean:
                try:
                    victim.submit(s, l)
                except ts.TenantQuarantinedError:
                    pass
                other.submit(s, l)
            with pytest.raises(ts.TenantQuarantinedError) as ctx:
                victim.compute(timeout=60)
            assert ctx.value.reason == reason
            got = other.compute(timeout=60)
    assert _bits(got) == _bits(_port_oracle(clean))


def test_chaos_ingest_delay_stalls_only_the_producer():
    with _ChaosEnv(
        TORCHEVAL_TPU_CHAOS="1",
        TORCHEVAL_TPU_CHAOS_ACTION="ingest_delay",
        TORCHEVAL_TPU_CHAOS_TENANT="slow",
        TORCHEVAL_TPU_CHAOS_STEP="1",
        TORCHEVAL_TPU_CHAOS_DELAY_S="0.5",
    ):
        with _tdaemon() as daemon:
            slow = daemon.attach("slow", _tacc())
            t0 = time.monotonic()
            slow.submit(*_batches(1, seed=12)[0])
            assert time.monotonic() - t0 >= 0.45
            assert slow.status is ts.TenantStatus.ACTIVE


# ------------------------------------------------------- obs: counters
def _serve_counters(snapshot):
    out = {k: v for k, v in snapshot["counters"].items() if k.startswith("serve.")}
    out.update(
        {f"{k}#count": v["count"] for k, v in snapshot["histograms"].items() if k.startswith("serve.submit.latency")}
    )
    return out


def _counter_scenario(S, acc, evict_dir):
    """Tenants that are served, shed, quarantined, evicted and re-attached,
    and a deduplicated replay: every per-tenant ``serve.*`` counter moves."""
    kw = {"device": "cpu"} if S is ts else {}
    batches = _batches(4, seed=20)
    with S.EvalDaemon(evict_dir=evict_dir, **kw) as daemon:
        ok = daemon.attach("ok", {"acc": acc()})
        bad = daemon.attach("bad", {"acc": acc()}, nan_policy="reject")
        ev = daemon.attach("ev", {"acc": acc()})
        for i, (s, l) in enumerate(batches):
            ok.submit(s, l, seq=i + 1)
            ev.submit(s.copy(), l.copy())  # distinct arrays: no cross-tenant dedup
        ok.submit(*batches[0], seq=2)  # a replay: deduplicated
        bad.submit(np.full((32, C), np.nan, np.float32), batches[0][1])
        with pytest.raises(S.TenantQuarantinedError):
            bad.compute(timeout=60)
        daemon.evict("ev", timeout=60)
        daemon.attach("ev", {"acc": acc()}, resume="require").compute(timeout=60)
        ok.compute(timeout=60)
        wedge = daemon.attach("wedge", {"acc": acc()}, queue_capacity=1)
        daemon._tenants["wedge"].capacity = 0  # shed the next submit
        with pytest.raises(S.BackpressureError):
            wedge.submit(*batches[0])


def test_serve_counters_equal_the_jax_packages(both_obs, tmp_path):
    _counter_scenario(ts, _tacc, str(tmp_path / "torch"))
    _counter_scenario(js, lambda: jm.MulticlassAccuracy(num_classes=C), str(tmp_path / "jax"))
    got, want = _serve_counters(tobs.snapshot()), _serve_counters(jobs.snapshot())
    # the H2D bytes count what each package's staging pass moved: both
    # stage the same numpy batches of the same tenants
    assert got == want
    for key in (
        "serve.ingest.batches{tenant=ok}",
        "serve.ingest.dupes{tenant=ok}",
        "serve.quarantines{reason=nan_policy,tenant=bad}",
        "serve.evictions{reason=explicit,tenant=ev}",
        "serve.ingest.sheds{reason=queue_full,tenant=wedge}",
        "serve.admissions{reason=resumed,result=accepted}",
    ):
        assert got.get(key, 0) > 0, key


# ---------------------------------------------------- obs: queue depth
def _depth_histo(tenant):
    return tobs.snapshot()["histograms"].get(f"serve.queue_depth{{tenant={tenant}}}")


def test_queue_depth_series_reaches_zero_after_drain(both_obs):
    with _tdaemon() as daemon:
        handle = daemon.attach("t1", {"acc": tm.MulticlassAccuracy(num_classes=4, device="cpu")})
        for _ in range(6):
            handle.submit(np.zeros(8, np.int64), np.zeros(8, np.int64), timeout=60)
        handle.compute(timeout=60)
        h = _depth_histo("t1")
        assert h is not None and h["count"] > 6
        zero_buckets = [
            value[0][0]
            for kind, name, _lb, value in treg.default_registry._items()
            if kind == "histo" and name == "serve.queue_depth"
        ]
        assert zero_buckets and zero_buckets[0] > 0


def test_queue_depth_record_is_gated_when_disabled():
    tobs.reset()
    with _tdaemon() as daemon:
        handle = daemon.attach("t1", {"acc": tm.MulticlassAccuracy(num_classes=4, device="cpu")})
        handle.submit(np.zeros(8, np.int64), np.zeros(8, np.int64), timeout=60)
        handle.compute(timeout=60)
    assert _depth_histo("t1") is None


# --------------------------------------------------------- load report
_SCHEMA_1 = {
    "schema": int, "ts": float, "uptime_s": float, "running": bool, "draining": bool,
    "capacity.max_tenants": int, "capacity.active_tenants": int, "queue.depth": int,
    "queue.capacity": int, "queue.per_tenant": dict, "ingest.backlog_bytes": int,
    "totals.attached": int, "totals.quarantined": int, "totals.evicted": int,
    "latency.submit_ewma_s": float, "latency.step_ewma_s": float,
    "latency.submit_p99_s": float, "latency.step_p99_s": float,
    "window.occupancy_mean": float, "window.samples": int,
    "hbm.bytes_max_entry": float, "hbm.bytes_sum": float,
}  # fmt: skip


def _lookup(report, path):
    node = report
    for part in path.split("."):
        node = node[part]
    return node


def test_load_report_schema_matches_the_jax_daemons(both_obs):
    with _tdaemon() as daemon, js.EvalDaemon() as jd:
        got, want = daemon.load_report(), jd.load_report()
        assert got["schema"] == want["schema"] == 1
        assert sorted(got) == sorted(want)
        for path, typ in _SCHEMA_1.items():
            assert isinstance(_lookup(got, path), typ), path
            assert isinstance(_lookup(want, path), typ), path
        json.dumps(got)
        assert daemon.health()["load_report"]["schema"] == 1
        tobs.disable()
        assert daemon.load_report()["running"]
        daemon.drain()
        assert daemon.load_report()["draining"]


def test_load_report_reflects_traffic(both_obs):
    with _tdaemon() as daemon:
        handle = daemon.attach("t1", {"acc": tm.MulticlassAccuracy(num_classes=4, device="cpu")})
        handle.submit(np.zeros(8, np.int64), np.zeros(8, np.int64), block=True, timeout=60)
        handle.compute(timeout=60)
        report = daemon.load_report()
    assert report["capacity"]["active_tenants"] == 1
    assert report["totals"]["attached"] == 1
    assert "t1" in report["queue"]["per_tenant"]
    assert report["latency"]["submit_ewma_s"] > 0.0
    assert report["latency"]["step_ewma_s"] > 0.0
    assert report["latency"]["submit_p99_s"] > 0.0
    assert report["window"]["samples"] > 0


# ------------------------------------------------------------ SLO drill
def test_slo_breach_drill_fires_exactly_one_alarm(both_obs):
    delay_s = 0.5
    tslo._reset_for_tests()
    alarms, lock = [], threading.Lock()

    def on_breach(payload):
        with lock:
            alarms.append(payload)

    tobs.on_alarm(on_breach)
    tobs.register_slo(
        tobs.Slo("submit_p99", instrument="serve.submit.latency", threshold_s=delay_s / 4.0, window_s=60.0, budget=0.01)
    )
    try:
        with _ChaosEnv(
            TORCHEVAL_TPU_CHAOS="1",
            TORCHEVAL_TPU_CHAOS_ACTION="ingest_delay",
            TORCHEVAL_TPU_CHAOS_TENANT="t1",
            TORCHEVAL_TPU_CHAOS_STEP="2",
            TORCHEVAL_TPU_CHAOS_DELAY_S=str(delay_s),
        ):
            with _tdaemon() as daemon:
                server = ts.EvalServer(daemon)
                client = ts.EvalClient(server.endpoint, request_timeout_s=60.0)
                try:
                    client.attach("t1", {"acc": ts.metric_spec("MulticlassAccuracy", num_classes=4)})
                    sub = client.subscribe_obs(0.1)
                    for _ in range(4):
                        client.submit("t1", np.zeros(8, np.int64), np.zeros(8, np.int64))
                    deadline = time.monotonic() + 15.0
                    while time.monotonic() < deadline and not alarms:
                        time.sleep(0.05)
                    time.sleep(0.5)
                    sub.stop()
                finally:
                    client.close()
                    server.close()
    finally:
        tslo._reset_for_tests()
    with lock:
        fired = json.loads(json.dumps(alarms, default=str))
    assert len(fired) == 1, fired
    assert (fired[0]["kind"], fired[0]["objective"]) == ("slo.breach", "submit_p99")
    assert "t1" in fired[0]["series"] and fired[0]["burn_rate"] >= 1.0
    snap = tobs.snapshot()
    assert snap["counters"].get("slo.breach{objective=submit_p99,tenant=t1}") == 1.0
    assert "slo.burn_rate{objective=submit_p99}" in snap["gauges"]
    assert snap["histograms"]["serve.submit.latency{tenant=t1}"]["p99"] >= delay_s / 4.0


# -------------------------------------------------------- approx knob
RNG = np.random.default_rng(9)
N = 4096
SCORES = RNG.random(N).astype(np.float32)
TARGETS = (RNG.random(N) < 0.4).astype(np.float32)


def _auroc_oracle(M, approx, **kw):
    m = M.BinaryAUROC(approx=approx, **kw)
    m.update(SCORES, TARGETS)
    return float(m.compute())


def test_attach_approx_matches_constructor_approx_and_jax():
    with _tdaemon() as daemon:
        h = daemon.attach("t", {"auroc": tm.BinaryAUROC(device="cpu")}, approx=4096)
        assert h._tenant.collection.metrics["auroc"]._sketch_enabled()
        h.submit(SCORES, TARGETS, block=True, timeout=120)
        got = float(h.compute(timeout=120)["auroc"])
    assert got == _auroc_oracle(tm, 4096, device="cpu")
    _close(got, _auroc_oracle(jm, 4096))


def test_approx_knob_member_switching():
    with _tdaemon() as daemon:
        members = daemon.attach(
            "t", {"auroc": tm.BinaryAUROC(device="cpu"), "acc": tm.MulticlassAccuracy(num_classes=2, device="cpu")},
            approx=True,
        )._tenant.collection.metrics
        assert members["auroc"]._sketch_enabled()
        assert not hasattr(members["acc"], "_sketch_enabled")
        h = daemon.attach("hr", {"hr": tm.HitRate(k=3, device="cpu")}, approx=True)
        assert h._tenant.collection.metrics["hr"]._sketch_enabled()
        daemon.attach("q", {"q": tm.Quantile(0.5, device="cpu")}, approx=True)
        h = daemon.attach("off", {"auroc": tm.BinaryAUROC(device="cpu")}, approx=False)
        assert not h._tenant.collection.metrics["auroc"]._sketch_enabled()


def _streamed():
    m = tm.BinaryAUROC(device="cpu")
    m.update(SCORES, TARGETS)
    return m


def _compacted():
    m = tm.BinaryAUROC(compaction_threshold=64, device="cpu")
    m.update(SCORES, TARGETS)
    m._compact()
    assert not m.inputs
    return m


@pytest.mark.parametrize(
    "make",
    [lambda: {"acc": tm.MulticlassAccuracy(num_classes=2, device="cpu")}, lambda: {"auroc": _streamed()},
     lambda: {"auroc": _compacted()}],
    ids=["no_capable_member", "streamed", "compacted"],
)  # fmt: skip
def test_approx_unswitchable_specs_reject_bad_metrics(make):
    with _tdaemon() as daemon:
        with pytest.raises(ts.AdmissionError) as ctx:
            daemon.attach("t", make(), approx=True)
        assert ctx.value.reason == "bad_metrics"
        daemon.attach("t", {"acc": tm.MulticlassAccuracy(num_classes=2, device="cpu")})


def test_rejected_admission_leaves_members_unswitched():
    good = tm.BinaryAUROC(device="cpu")
    with _tdaemon() as daemon:
        with pytest.raises(ts.AdmissionError):
            daemon.attach("t", {"good": good, "bad": _streamed()}, approx=True)
    assert not good._sketch_enabled()
    good.update(SCORES, TARGETS)
    assert float(good.compute()) == _auroc_oracle(tm, None, device="cpu")


def test_wire_attach_threads_approx_and_rejects_structurally():
    with _tdaemon() as daemon:
        server = ts.EvalServer(daemon)
        client = ts.EvalClient(server.endpoint, request_timeout_s=120.0)
        try:
            client.attach("w", {"auroc": ["BinaryAUROC", {}]}, approx=4096)
            client.submit("w", SCORES, TARGETS)
            assert float(np.asarray(client.compute("w")["auroc"])) == _auroc_oracle(tm, 4096, device="cpu")
            with pytest.raises(ts.AdmissionError) as ctx:
                client.attach("w2", {"acc": ["MulticlassAccuracy", {"num_classes": 2}]}, approx=True)
            assert ctx.value.reason == "bad_metrics"
        finally:
            client.close()
            server.close()


# ------------------------------------------------------ sliced tenants
def _sliced_batches(seed=0, n_batches=3, n=200):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        ids = rng.integers(0, 9, n).astype(np.int64) * 13 - 5
        out.append((ids, rng.random(n).astype(np.float32), (rng.random(n) < 0.4).astype(np.float32)))
    return out


def _sliced_spec(M, **kw):
    return {"acc": M.BinaryAccuracy(**kw), "auroc": M.BinaryAUROC(**kw)}


def _assert_sliced_equal(got, want, exact=True):
    for key in ("acc", "auroc"):
        np.testing.assert_array_equal(np.asarray(got[key]["slice_ids"]), np.asarray(want[key]["slice_ids"]))
        if exact:
            assert _bits(got[key]["values"]) == _bits(want[key]["values"])
        else:
            _close(got[key]["values"], want[key]["values"])


def test_sliced_attach_submit_compute_matches_jax():
    batches = _sliced_batches()
    with _tdaemon() as daemon:
        h = daemon.attach("t1", _sliced_spec(tm, device="cpu"), approx=1024, slices={"capacity": 4})
        assert isinstance(h._tenant.collection, tm.SlicedMetricCollection)
        for b in batches:
            h.submit(*b)
        got = h.compute()
        assert sorted(got["acc"]) == ["slice_ids", "values"]
        assert len(got["acc"]["slice_ids"]) == len(np.unique(np.concatenate([b[0] for b in batches])))
        h.detach()
    with js.EvalDaemon() as jd:
        jh = jd.attach("t1", _sliced_spec(jm), approx=1024, slices={"capacity": 4})
        for b in batches:
            jh.submit(*b)
        want = jh.compute()
    _assert_sliced_equal(got, want, exact=False)


def test_sliced_knob_shapes_and_prebuilt_collection():
    with _tdaemon() as daemon:
        daemon.attach("a", _sliced_spec(tm, device="cpu"), approx=True, slices=True).detach()
        daemon.attach("b", _sliced_spec(tm, device="cpu"), approx=True, slices=16).detach()
        with pytest.raises(ValueError):
            daemon.attach("c", _sliced_spec(tm, device="cpu"), approx=True, slices={"nope": 1})
        with pytest.raises(ValueError):
            daemon.attach("d", _sliced_spec(tm, device="cpu"), approx=True, slices="yes")
        col = tm.SlicedMetricCollection({"acc": tm.BinaryAccuracy(device="cpu")}, capacity=8)
        h = daemon.attach("t1", col, slices=True)
        assert h._tenant.collection is col
        h.detach()
        # the flat mesh needs a torch.distributed world, which this process lacks
        with pytest.raises(ts.AdmissionError) as ctx:
            daemon.attach("m", _sliced_spec(tm, device="cpu"), approx=True, slices={"mesh_axis": "s"})
        assert ctx.value.reason == "bad_metrics"


def test_sliced_evict_reattach_round_trips_id_table(tmp_path):
    batches = _sliced_batches(seed=2)
    with _tdaemon(evict_dir=str(tmp_path)) as daemon:
        h = daemon.attach("t1", _sliced_spec(tm, device="cpu"), approx=1024, slices={"capacity": 2})
        for b in batches:
            h.submit(*b)
        want = h.compute()
        table = h._tenant.collection.slice_table.registered_ids()
        daemon.evict("t1")
        h2 = daemon.attach(
            "t1", _sliced_spec(tm, device="cpu"), approx=1024, slices={"capacity": 2}, resume="require"
        )
        np.testing.assert_array_equal(h2._tenant.collection.slice_table.registered_ids(), table)
        _assert_sliced_equal(h2.compute(), want)
        ids, s, t = batches[0]
        h2.submit(ids * 31 + 2, s, t)
        h2.compute()


def test_sliced_validate_then_commit():
    cat, auroc = tm.Cat(device="cpu"), tm.BinaryAUROC(device="cpu")
    with _tdaemon() as daemon:
        with pytest.raises(ts.AdmissionError) as ctx:
            daemon.attach("t1", {"auroc": auroc, "cat": cat}, approx=1024, slices=True)
        assert ctx.value.reason == "bad_metrics"
        with pytest.raises(ts.AdmissionError) as ctx:
            daemon.attach("t2", _sliced_spec(tm, device="cpu"), slices=True)
        assert ctx.value.reason == "bad_metrics" and "approx" in str(ctx.value)
        h = daemon.attach("t3", _sliced_spec(tm, device="cpu"), approx=1024, slices=True)
        assert h._tenant.collection.metrics["auroc"]._bits == 10
    assert not cat._sketch_enabled()
    assert "summary_tp" in auroc._state_name_to_default


def test_sliced_wire_attach_matches_local():
    batches = _sliced_batches(seed=4)
    with _tdaemon() as local:
        h = local.attach("ref", _sliced_spec(tm, device="cpu"), approx=1024, slices={"capacity": 4})
        for b in batches:
            h.submit(*b)
        want = h.compute()
    with _tdaemon() as daemon:
        server = ts.EvalServer(daemon)
        client = ts.EvalClient(server.endpoint, request_timeout_s=30.0)
        try:
            spec = {"acc": ts.metric_spec("BinaryAccuracy"), "auroc": ts.metric_spec("BinaryAUROC")}
            client.attach("w1", spec, approx=1024, slices={"capacity": 4})
            for b in batches:
                client.submit("w1", *b)
            _assert_sliced_equal(client.compute("w1"), want)
            with pytest.raises(ts.AdmissionError) as ctx:
                client.attach("w2", {"auroc": ts.metric_spec("BinaryAUROC")}, slices=True)
            assert ctx.value.reason == "bad_metrics"
        finally:
            client.close()
            server.close()
