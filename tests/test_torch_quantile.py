"""The port's ``Quantile``, ``Cat`` and the ``approx=`` modes of ``HitRate``
and ``ReciprocalRank`` against the JAX package's, on the CPU.

Mirrors ``tests/sketch/test_quantile.py`` and adds ``Cat``'s exact mode.
The same seeded numpy values go through both packages (``device="cpu"``
on the port's metrics, where the segment-sum wrapper runs its plain
version): bucket counts equal exactly, quantiles and means within atol
1e-8, rtol 1e-5, and within ``sketch.relative_error(16)`` of the exact
order statistic (plus 1.2e-38 for subnormal magnitudes, which flush to the
zero bucket).
"""

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu_torch import metrics as TM
from torcheval_tpu_torch import sketch as T
from torcheval_tpu_torch.utils.test_utils.obs_counts import folding_window_steps, recording


@pytest.fixture
def obs_on():
    """The obs registry on (and reset) for a test that counts launches,
    folds or rounds: the registry is the port's one counter."""
    with recording():
        yield


RTOL, ATOL = 1e-5, 1e-8
CPU = "cpu"


def _true_quantile(values, q):
    sv = np.sort(values)
    return float(sv[max(int(np.ceil(q * len(values))) - 1, 0)])


def _dists():
    rng = np.random.default_rng(0)
    return {
        "lognormal_heavy": rng.lognormal(0, 4, 20001),
        "normal_signed": rng.normal(0, 100, 20001),
        "tied": rng.choice([1.0, 2.0, 2.0, 7.5], 20001),
        "tiny_and_huge": np.concatenate([rng.lognormal(-60, 2, 10000), rng.lognormal(60, 2, 10001)]),
    }


DISTS = _dists()
QS = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(DISTS))
def test_quantile_matches_jax_and_true_order_statistic(name):
    v = DISTS[name].astype(np.float32)
    jm, tm = JM.Quantile(q=QS), TM.Quantile(q=QS, device=CPU)
    for chunk in np.array_split(v, 5):
        jm.update(chunk)
        tm.update(chunk)
    got = tm.compute()
    np.testing.assert_allclose(_np(got), np.asarray(jm.compute()), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tm.state_dict()["bucket_counts"].numpy(),
                                  np.asarray(jm.state_dict()["bucket_counts"]))
    for q, e in zip(QS, _np(got)):
        true = _true_quantile(v, q)
        assert abs(float(e) - true) <= T.relative_error(16) * abs(true) + 1.2e-38, (name, q)


def test_quantile_ragged_batches_and_stacked_fold_equal():
    rng = np.random.default_rng(1)
    uniform = [rng.random(777).astype(np.float32) for _ in range(6)]
    ragged = [rng.random(n).astype(np.float32) for n in (100, 333, 7, 1000)]
    for batches in (uniform, ragged):
        a, b = TM.Quantile(0.5, device=CPU), JM.Quantile(0.5)
        for x in batches:
            a.update(x)
            b.update(x)
        np.testing.assert_array_equal(a.state_dict()["bucket_counts"].numpy(),
                                      np.asarray(b.state_dict()["bucket_counts"]))


def test_quantile_scalar_q_validation_empty_nan_and_inf():
    m = TM.Quantile(0.5, device=CPU).update(np.float32([1, 2, 3]))
    assert m.compute().shape == ()
    for bad_q in (-0.1, 1.5, float("nan"), ()):
        with pytest.raises(ValueError):
            TM.Quantile(bad_q, device=CPU)
    with pytest.raises(ValueError):
        TM.Quantile(0.5, bucket_count=1000, device=CPU)
    with pytest.raises(ValueError):
        TM.Quantile(0.5, nan_policy="bogus", device=CPU)
    assert np.isnan(float(TM.Quantile(0.5, device=CPU).compute()))
    bad = TM.Quantile(0.5, device=CPU).update(np.float32([1.0, np.nan]))
    with pytest.raises(ValueError, match="NaN"):
        bad.compute()
    ok = TM.Quantile(0.5, nan_policy="ignore", device=CPU).update(np.float32([np.nan, 2.0, 2.0, np.nan]))
    assert abs(float(ok.compute()) - 2.0) / 2.0 <= T.relative_error(16)
    assert int(ok.nan_dropped) == 2
    lo, hi = _np(TM.Quantile((0.0, 1.0), device=CPU).update(np.float32([-np.inf, 0.0, np.inf])).compute())
    assert lo == -np.inf and hi == np.inf


def test_quantile_merge_window_state_dict_and_schema(obs_on):
    rng = np.random.default_rng(2)
    v = rng.lognormal(1, 2, 9000).astype(np.float32)
    solo, a, b = (TM.Quantile(0.5, device=CPU) for _ in range(3))
    for i, chunk in enumerate(np.array_split(v, 6)):
        (a if i % 2 else b).update(chunk)
        solo.update(chunk)
    a.merge_state([b])
    solo._fold_now()
    assert torch.equal(a.bucket_counts, solo.bucket_counts)
    assert float(a.compute()) == float(solo.compute())
    # one window step for the whole collection: the sketch is plain state
    col = TM.MetricCollection({"q": TM.Quantile(0.5, device=CPU), "m": TM.Mean(device=CPU)})
    w = rng.random(6000).astype(np.float32)
    steps = folding_window_steps()
    for chunk in np.array_split(w, 4):
        col.update(chunk)
    out = col.compute()
    assert folding_window_steps() - steps == 1
    assert abs(float(out["q"]) - _true_quantile(w, 0.5)) <= T.relative_error(16)
    m = TM.Quantile((0.1, 0.9), device=CPU)
    m.update(rng.random(1000).astype(np.float32))
    m.update(rng.random(1000).astype(np.float32))  # pending batches
    fresh = TM.Quantile((0.1, 0.9), device=CPU)
    fresh.load_state_dict(m.state_dict())
    assert torch.equal(fresh.compute(), m.compute())
    assert TM.Quantile(0.5, device=CPU)._sync_schema_extra != TM.Quantile(
        0.5, bucket_count=4096, device=CPU)._sync_schema_extra


def test_quantile_int32_edge_fails_closed():
    m = TM.Quantile(0.5, bucket_count=4096, device=CPU)
    big = np.zeros(4096, np.int32)
    big[:8] = 2**28
    m.bucket_counts = torch.from_numpy(big)
    with pytest.raises(ValueError, match="int32-exact"):
        m.compute()


def test_quantile_is_sliceable_like_jax():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 5, 400)
    v = rng.normal(size=400).astype(np.float32)
    t = TM.SlicedMetricCollection({"q": TM.Quantile(0.5, bucket_count=1024, device=CPU)})
    j = JM.SlicedMetricCollection({"q": JM.Quantile(0.5, bucket_count=1024)})
    t.update(ids, v)
    j.update(ids, v)
    rt, rj = t.compute()["q"], j.compute()["q"]
    np.testing.assert_array_equal(rt.slice_ids, np.asarray(rj.slice_ids))
    np.testing.assert_allclose(_np(rt["values"]), np.asarray(rj["values"]), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------- value sketches
def _rank_batches(k=4, c=10, n=600, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.random((n, c)).astype(np.float32), rng.integers(0, c, n)) for _ in range(k)]


@pytest.mark.parametrize("cls", ["HitRate", "ReciprocalRank"])
def test_ranking_approx_matches_jax_and_exact_mean(cls):
    batches = _rank_batches()
    kw = {"k": 3} if cls == "HitRate" else {}
    jm = getattr(JM, cls)(approx=True, **kw)
    tm = getattr(TM, cls)(approx=True, device=CPU, **kw)
    exact = getattr(TM, cls)(device=CPU, **kw)
    for x, t in batches:
        jm.update(x, t)
        tm.update(x, t)
        exact.update(x, t)
    got = float(tm.compute())
    assert got == pytest.approx(float(jm.compute()), rel=RTOL, abs=ATOL)
    want = float(exact.compute().mean())
    assert abs(want - got) <= T.relative_error(16) * max(want, 1e-9) + 1e-6
    a, b = getattr(TM, cls)(approx=True, device=CPU, **kw), getattr(TM, cls)(approx=True, device=CPU, **kw)
    for i, (x, t) in enumerate(batches):
        (a if i % 2 else b).update(x, t)
    a.merge_state([b])
    assert float(a.compute()) == got


def test_value_sketch_bounded_staging_and_nan():
    rng = np.random.default_rng(6)
    m = TM.HitRate(approx=4096, device=CPU)
    for _ in range(3):
        x = rng.random((T.SKETCH_FOLD_ROWS // 2 + 10, 4)).astype(np.float32)
        m.update(x, rng.integers(0, 4, x.shape[0]))
        assert sum(int(a.numel()) for a in m.scores) < T.SKETCH_FOLD_ROWS + x.shape[0]
    assert tuple(m.sketch_counts.shape) == (4096,)
    bad = TM.Cat(approx=True, device=CPU).update(np.float32([np.nan]))
    with pytest.raises(ValueError, match="NaN"):
        bad.compute()


def test_cat_approx_weighted_histogram_view_matches_jax():
    jc, tc = JM.Cat(approx=True), TM.Cat(approx=True, device=CPU)
    for x in (np.float32([3.0, 1.0, 3.0]), np.float32([[1.0, 3.0]])):
        jc.update(x)
        tc.update(x)
    vals, counts = tc.compute()
    jv, jn = jc.compute()
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jn))
    assert int(counts.sum()) == 5 and len(vals) == 2
    for got, true in zip(sorted(vals.tolist()), (1.0, 3.0)):
        assert abs(got - true) / true <= T.relative_error(16)
    with pytest.raises(ValueError, match="dim=0"):
        TM.Cat(dim=1, approx=True, device=CPU)
    other = TM.Cat(approx=True, device=CPU).update(np.float32([2.0]))
    other._prepare_for_merge_state()
    tc.merge_state([other])
    assert int(tc.compute()[1].sum()) == 6
    tc.reset()
    assert tc.compute()[0].numel() == 0


def test_cat_env_opt_in_with_dim_stays_exact(monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_APPROX", "1")
    assert not TM.Cat(dim=1, device=CPU)._sketch_enabled()
    assert TM.Cat(device=CPU)._sketch_enabled()
    with pytest.raises(ValueError):
        TM.Cat(dim=1, approx=True, device=CPU)


@pytest.mark.parametrize("dim", [0, 1])
def test_cat_exact_mode_matches_jax_including_merge_quirk(dim):
    rng = np.random.default_rng(7)
    xs = [rng.random((3, 4)).astype(np.float32) for _ in range(3)]
    jc, tc = JM.Cat(dim=dim), TM.Cat(dim=dim, device=CPU)
    for x in xs:
        jc.update(x)
        tc.update(x)
    np.testing.assert_array_equal(tc.compute().numpy(), np.asarray(jc.compute()))
    assert TM.Cat(device=CPU).compute().shape == (0,)
    # merging concatenates each source's cache along the SOURCE's dim
    jsrc, tsrc = JM.Cat(dim=1 - dim), TM.Cat(dim=1 - dim, device=CPU)
    for x in xs[:2]:
        jsrc.update(x)
        tsrc.update(x)
    jc.merge_state([jsrc])
    tc.merge_state([tsrc])
    assert [tuple(a.shape) for a in tc.inputs] == [tuple(a.shape) for a in jc.inputs]
    for a, b in zip(tc.inputs, jc.inputs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the pre-sync compaction concatenates along the metric's own dim
    one, jone = TM.Cat(dim=dim, device=CPU), JM.Cat(dim=dim)
    for x in xs:
        one.update(x)
        jone.update(x)
    one._prepare_for_merge_state()
    jone._prepare_for_merge_state()
    assert len(one.inputs) == 1
    np.testing.assert_array_equal(one.inputs[0].numpy(), np.asarray(jone.inputs[0]))
