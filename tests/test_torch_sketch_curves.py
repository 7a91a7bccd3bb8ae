"""The port's sketch folds, computes and ``approx=`` curve metrics against
the JAX package's, on the CPU.

Mirrors ``tests/sketch/test_sketch_curves.py``. The same seeded numpy
streams (smooth, heavy-tailed, massively tied, constant, one-class labels,
with +-inf, -0.0 and subnormal scores) go through both packages, with
``device="cpu"`` on the port's metrics, where the segment-sum wrapper runs
its plain version. Fold counts must be equal exactly; curve values, PRC
points, means and quantiles within atol 1e-8, rtol 1e-5; the error bounds
equal (float64 host math on equal counts). A sketch fold on a tensor that
is not on the CPU launches the kernel or raises: it never falls back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu import sketch as J
from torcheval_tpu.sketch import histogram as JH
from torcheval_tpu_torch import _build
from torcheval_tpu_torch import metrics as TM
from torcheval_tpu_torch import sketch as T
from torcheval_tpu_torch.sketch import cache as TC
from torcheval_tpu_torch.sketch import histogram as TH
from torcheval_tpu_torch.utils.test_utils.obs_counts import count, launches, recording


@pytest.fixture
def obs_on():
    """The obs registry on (and reset) for a test that counts launches,
    folds or rounds: the registry is the port's one counter."""
    with recording():
        yield


RTOL, ATOL = 1e-5, 1e-8
CPU = "cpu"


def _streams(seed=1234, n=3000):
    rng = np.random.default_rng(seed)

    def chunks(s, t, k=4):
        return list(zip(np.array_split(s.astype(np.float32), k), np.array_split(t, k)))

    smooth = rng.normal(size=n).astype(np.float32)
    heavy = np.concatenate([rng.lognormal(0, 5, n // 2), -rng.lognormal(0, 5, n - n // 2)])
    tied = rng.choice(np.float32([0.1, 0.5, 0.5, 0.9]), n)
    special = smooth.copy()
    special[::97] = np.inf
    special[1::89] = -np.inf
    special[2::83] = -0.0
    special[3::79] = 1e-40
    t = (rng.random(n) < 0.35).astype(np.float32)
    return {
        "smooth": chunks(smooth, t),
        "heavy_tail": chunks(heavy.astype(np.float32), t),
        "massive_ties": chunks(tied, t),
        "constant": chunks(np.full(n, np.float32(0.25)), t),
        "degenerate_labels": chunks(smooth, np.ones(n, np.float32)),
        "special_values": chunks(special, t),
    }


STREAMS = _streams()


def _fill(metric, stream):
    for s, t in stream:
        metric.update(s, t)
    return metric


def _close(got, want):
    g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(g.astype(np.float64), np.asarray(want, np.float64), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ folds
@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("bits", [10, 16])
def test_binary_fold_counts_exact(name, bits):
    s = np.concatenate([c[0] for c in STREAMS[name]])
    t = np.concatenate([c[1] for c in STREAMS[name]])
    s[::501] = np.nan
    jtp, jfp, jnan = J.score_hist_fold(jnp.asarray(s), jnp.asarray(t), bits)
    tp, fp, nan = T.score_hist_fold(torch.from_numpy(s), torch.from_numpy(t), bits)
    assert tp.dtype == fp.dtype == nan.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jtp))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(jfp))
    assert int(nan) == int(jnan) == len(s[::501])


@pytest.mark.parametrize("sdtype", ["float32", "float16", "float64"])
@pytest.mark.parametrize("target", ["float32", "int64", "bool"])
def test_cpu_binary_fold_is_the_plain_composition_and_counts_no_fused_fold(obs_on, sdtype, target):
    """On the CPU the fold stays the tensor-op composition (the card's
    fused fold is held to it bit for bit): the JAX package's counts, one
    ``segment_sum`` of the plain version, no ``sketch.fused_folds``."""
    rng = np.random.default_rng(31)
    s = np.concatenate([c[0] for c in STREAMS["special_values"]]).astype(sdtype)
    s[::211] = np.nan
    t = rng.integers(-1, 3, s.shape) if target == "int64" else rng.random(s.shape) < 0.4
    t = t.astype(target)
    jtp, jfp, jnan = J.score_hist_fold(jnp.asarray(s), jnp.asarray(t), 16)
    for fold in (T.score_hist_fold, TH.score_hist_fold_plain):
        tp, fp, nan = fold(torch.from_numpy(s), torch.from_numpy(t), 16)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jtp))
        np.testing.assert_array_equal(fp.numpy(), np.asarray(jfp))
        assert int(nan) == int(jnan) == len(s[::211])
    keep = torch.from_numpy(~np.isnan(s))
    m = TM.BinaryAUROC(approx=True, device=CPU)
    m.update(torch.from_numpy(s)[keep], torch.from_numpy(t)[keep].float().clamp(0, 1))
    m._score_sketch_fold()
    m.compute()
    assert count("sketch.folds", kind="score") == 1
    assert count("sketch.fused_folds") == 0 and launches("segment_sum") == 0


def test_card_binary_fold_takes_the_fused_launch(monkeypatch, obs_on):
    """Off the CPU the fold is one ``score_segment_sum`` launch, whose
    ``(B, 2)`` counts come back as the ``(tp, fp)`` columns."""
    calls = []

    def fused(scores, targets, bits):
        calls.append((scores, targets, bits))
        hist = torch.arange(2 << bits, dtype=torch.int32).view(1 << bits, 2)
        return hist, torch.tensor(7, dtype=torch.int32)

    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    monkeypatch.setattr(TH, "score_segment_sum", fused)
    s, t = torch.rand(10), torch.ones(10)
    tp, fp, nan = T.score_hist_fold(s, t, 10)
    assert len(calls) == 1 and calls[0][0] is s and calls[0][1] is t and calls[0][2] == 10
    assert tp.is_contiguous() and fp.is_contiguous()
    assert tp.tolist() == list(range(0, 2048, 2)) and fp.tolist() == list(range(1, 2048, 2))
    assert int(nan) == 7
    with pytest.raises(ValueError, match="bucket_bits"):
        T.score_hist_fold(s, t, 9)


@pytest.mark.parametrize("bits", [10, 12])
def test_multiclass_fold_counts_exact(bits):
    rng = np.random.default_rng(7)
    c, n = 6, 2500
    s = rng.random((n, c)).astype(np.float32)
    s[::37, 2] = np.nan
    s[5::41] = np.inf
    lbl = rng.integers(0, c, n)
    jtp, jfp, jnan = J.mc_score_hist_fold(jnp.asarray(s), jnp.asarray(lbl), bits, c)
    tp, fp, nan = T.mc_score_hist_fold(torch.from_numpy(s), torch.from_numpy(lbl), bits, c)
    assert tuple(tp.shape) == (c, 1 << bits)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jtp))
    np.testing.assert_array_equal(fp.numpy(), np.asarray(jfp))
    assert int(nan) == int(jnan)


@pytest.mark.parametrize("shape", [(3000,), (40, 25), (0,)])
def test_value_fold_counts_exact(shape):
    rng = np.random.default_rng(11)
    v = rng.lognormal(0, 4, shape).astype(np.float32) * np.where(rng.random(shape) < 0.3, -1, 1)
    if v.size:
        v.reshape(-1)[::17] = np.nan
    jc, jnan = J.value_hist_fold(jnp.asarray(v), 16)
    c, nan = T.value_hist_fold(torch.from_numpy(v), 16)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert int(nan) == int(jnan)


def test_value_fold_under_vmap_is_one_segment_sum_per_batch_set():
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.normal(size=(5, 300)).astype(np.float32))
    counts, nan = torch.func.vmap(lambda x: T.value_hist_fold(x, 10))(v)
    for i in range(5):
        want, _ = T.value_hist_fold(v[i], 10)
        assert torch.equal(counts[i], want)
    assert nan.tolist() == [0] * 5


def test_folds_are_additive_over_chunks():
    s = np.concatenate([c[0] for c in STREAMS["heavy_tail"]])
    t = np.concatenate([c[1] for c in STREAMS["heavy_tail"]])
    whole = T.score_hist_fold(torch.from_numpy(s), torch.from_numpy(t), 12)
    parts = [T.score_hist_fold(torch.from_numpy(a), torch.from_numpy(b), 12)
             for a, b in STREAMS["heavy_tail"]]
    for k in range(3):
        assert torch.equal(sum(p[k] for p in parts), whole[k])


# --------------------------------------------------------------- computes
def _hist(name, bits):
    s = np.concatenate([c[0] for c in STREAMS[name]])
    t = np.concatenate([c[1] for c in STREAMS[name]])
    return T.score_hist_fold(torch.from_numpy(s), torch.from_numpy(t), bits)[:2]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_auroc_auprc_prc_from_hist_match(name):
    tp, fp = _hist(name, 12)
    jtp, jfp = jnp.asarray(tp.numpy()), jnp.asarray(fp.numpy())
    _close(T.auroc_from_hist(tp, fp, 12), J.auroc_from_hist(jtp, jfp, 12))
    _close(T.auprc_from_hist(tp, fp, 12), J.auprc_from_hist(jtp, jfp, 12))
    for got, want in zip(T.prc_from_hist(tp, fp, 12), J.prc_from_hist(jtp, jfp, 12)):
        assert got.shape[0] == want.shape[0]
        _close(got, want)
    for got, want in zip(TH.prc_points_from_hist(tp, fp), JH.prc_points_from_hist(jtp, jfp)):
        _close(got, want)
    assert T.auroc_error_bound(tp, fp) == J.auroc_error_bound(jtp, jfp)
    assert T.auprc_error_bound(tp, fp) == J.auprc_error_bound(jtp, jfp)


def test_multiclass_computes_along_the_last_axis():
    rng = np.random.default_rng(5)
    s = rng.random((2000, 4)).astype(np.float32)
    lbl = rng.integers(0, 4, 2000)
    tp, fp, _ = T.mc_score_hist_fold(torch.from_numpy(s), torch.from_numpy(lbl), 12, 4)
    auroc = T.auroc_from_hist(tp, fp, 12)
    for c in range(4):
        want = J.auroc_from_hist(jnp.asarray(tp[c].numpy()), jnp.asarray(fp[c].numpy()), 12)
        _close(auroc[c], want)


@pytest.mark.parametrize("q", [(0.0,), (0.01, 0.25, 0.5, 0.9, 0.99, 1.0)])
def test_quantiles_and_mean_from_counts_match(q):
    rng = np.random.default_rng(9)
    v = np.concatenate([rng.lognormal(0, 4, 3000), -rng.normal(0, 50, 1000)]).astype(np.float32)
    c, _ = T.value_hist_fold(torch.from_numpy(v), 16)
    jc = jnp.asarray(c.numpy())
    _close(T.quantiles_from_counts(c, q, 16), J.quantiles_from_counts(jc, q, 16))
    _close(T.mean_from_counts(c, 16), J.mean_from_counts(jc, 16))
    empty = torch.zeros(1 << 16, dtype=torch.int32)
    assert torch.isnan(T.quantiles_from_counts(empty, q, 16)).all()
    assert float(T.mean_from_counts(empty, 16)) == 0.0


def test_subnormal_mean_within_stated_bound():
    # three values in bucket 32769 at 16 bits: XLA on the CPU flushes the
    # subnormal product of the mean to 0.0, torch keeps about 4.13e-40; the
    # stated bound is atol 1e-8 (no flush is added on either side), and the
    # quantile is a gather that returns the subnormal representative in both
    c = np.zeros(1 << 16, np.int32)
    c[32769] = 3
    got = float(T.mean_from_counts(torch.from_numpy(c), 16))
    want = float(J.mean_from_counts(jnp.asarray(c), 16))
    assert abs(got - want) <= ATOL
    np.testing.assert_array_equal(
        T.quantiles_from_counts(torch.from_numpy(c), (0.5,), 16).numpy(),
        np.asarray(J.quantiles_from_counts(jnp.asarray(c), (0.5,), 16)),
    )


def test_counts_exactness_flag_matches():
    per_class = np.zeros((1000, 4096), np.int32)
    per_class[:, :2] = 2**20
    hot = per_class.copy()
    hot[3, :4] = 2**29
    wrapped = np.zeros(4096, np.int32)
    wrapped[7] = -5
    for arr in (per_class, hot, wrapped):
        assert bool(TH.counts_exactness_flag(torch.from_numpy(arr))) == bool(
            JH.counts_exactness_flag(jnp.asarray(arr)))
    assert not bool(TH.counts_exactness_flag(torch.from_numpy(per_class)))
    assert bool(TH.counts_exactness_flag(torch.from_numpy(hot)))


# ---------------------------------------------------------------- metrics
@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("cls", ["BinaryAUROC", "BinaryAUPRC"])
def test_binary_approx_metric_matches_and_stays_within_bound(name, cls):
    stream = STREAMS[name]
    jm = _fill(getattr(JM, cls)(approx=True, compaction_threshold=1024), stream)
    tm = _fill(getattr(TM, cls)(approx=True, compaction_threshold=1024, device=CPU), stream)
    got = tm.compute()
    _close(got, jm.compute())
    tm._score_sketch_fold()
    jm._compact()
    np.testing.assert_array_equal(tm.sketch_tp.numpy(), np.asarray(jm.sketch_tp))
    np.testing.assert_array_equal(tm.sketch_fp.numpy(), np.asarray(jm.sketch_fp))
    exact = float(_fill(getattr(TM, cls)(device=CPU), stream).compute())
    bound = (T.auroc_error_bound if cls == "BinaryAUROC" else T.auprc_error_bound)(
        tm.sketch_tp, tm.sketch_fp)
    assert abs(exact - float(got)) <= bound + 1e-6


@pytest.mark.parametrize("cls", ["MulticlassAUROC", "MulticlassAUPRC"])
@pytest.mark.parametrize("average", ["macro", None])
def test_multiclass_approx_metric_matches(cls, average):
    rng = np.random.default_rng(1234)
    c = 6
    s = rng.random((4000, c)).astype(np.float32)
    lbl = rng.integers(0, c, 4000)
    stream = list(zip(np.array_split(s, 4), np.array_split(lbl, 4)))
    jm = _fill(getattr(JM, cls)(num_classes=c, average=average, approx=True,
                                compaction_threshold=1500), stream)
    tm = _fill(getattr(TM, cls)(num_classes=c, average=average, approx=True,
                                compaction_threshold=1500, device=CPU), stream)
    _close(tm.compute(), jm.compute())
    assert tuple(tm.sketch_tp.shape) == (c, 1 << 12)
    tm._score_sketch_fold()
    jm._compact()
    np.testing.assert_array_equal(tm.sketch_tp.numpy(), np.asarray(jm.sketch_tp))
    if average is None:
        exact = _fill(getattr(TM, cls)(num_classes=c, average=None, device=CPU), stream).compute()
        bound = T.auroc_error_bound if cls == "MulticlassAUROC" else T.auprc_error_bound
        got = tm.compute()
        for k in range(c):
            assert abs(float(exact[k]) - float(got[k])) <= bound(tm.sketch_tp[k], tm.sketch_fp[k]) + 1e-6


def test_empty_defaults_and_inf_scores():
    assert float(TM.BinaryAUROC(approx=True, device=CPU).compute()) == 0.5
    assert float(TM.BinaryAUPRC(approx=True, device=CPU).compute()) == 0.0
    s = np.float32([np.inf, -np.inf, 0.5, 0.1])
    t = np.float32([1, 0, 1, 0])
    m = TM.BinaryAUROC(approx=True, device=CPU).update(s, t)
    first = float(m.compute())
    assert first == float(m.compute())
    assert first == pytest.approx(float(TM.BinaryAUROC(device=CPU).update(s, t).compute()), abs=1e-6)


def test_nan_scores_raise_and_keep_raising():
    for make, noun in ((lambda: TM.BinaryAUROC(approx=True, device=CPU), "sample"),
                       (lambda: TM.BinaryAUPRC(approx=True, device=CPU), "sample")):
        m = make()
        m.update(np.float32([0.2, np.nan, 0.7]), np.float32([1, 0, 1]))
        with pytest.raises(ValueError, match=f"1 {noun}.*NaN"):
            m.compute()
        m._score_sketch_fold()
        with pytest.raises(ValueError, match="NaN"):
            m.compute()
    mc = TM.MulticlassAUROC(num_classes=3, approx=True, device=CPU)
    s = np.random.default_rng(0).random((10, 3)).astype(np.float32)
    s[0, 1] = np.nan
    mc.update(s, np.arange(10) % 3)
    with pytest.raises(ValueError, match="per-class"):
        mc.compute()


def test_compute_is_idempotent_and_compute_update_compute_matches_jax():
    stream = STREAMS["smooth"]
    jm = JM.BinaryAUROC(approx=True, compaction_threshold=1000)
    tm = TM.BinaryAUROC(approx=True, compaction_threshold=1000, device=CPU)
    results = []
    for (s, t) in stream:
        jm.update(s, t)
        tm.update(s, t)
        a, b = float(tm.compute()), float(tm.compute())
        assert a == b  # compute leaves state as it was
        results.append((a, float(jm.compute())))
        assert sum(int(x.shape[0]) for x in tm.inputs) == sum(int(x.shape[0]) for x in jm.inputs)
    for got, want in results:
        assert got == pytest.approx(want, rel=RTOL, abs=ATOL)


def test_bounded_state_and_sync_ships_the_sketch_only():
    def run(n_batches):
        m = TM.BinaryAUROC(approx=4096, compaction_threshold=2048, device=CPU)
        for i in range(n_batches):
            rng = np.random.default_rng(i)
            m.update(rng.random(512).astype(np.float32), (rng.random(512) < 0.5).astype(np.float32))
            assert sum(int(a.shape[0]) for a in m.inputs) < 2048 + 512
        m._score_sketch_fold()
        return sum(v.numel() * v.element_size() for v in (m.sketch_tp, m.sketch_fp, m.sketch_nan_dropped))

    assert run(5) == run(50) == 2 * 4096 * 4 + 4
    m = TM.BinaryAUROC(approx=4096, device=CPU)
    m.update(np.random.default_rng(0).random(10_000).astype(np.float32), np.ones(10_000, np.float32))
    m._prepare_for_merge_state()
    assert m.inputs == [] and m.targets == []


def test_merge_bit_identical_to_single_stream_and_reset():
    stream = STREAMS["heavy_tail"]
    solo = _fill(TM.BinaryAUROC(approx=True, device=CPU), stream)
    a = _fill(TM.BinaryAUROC(approx=True, device=CPU), stream[:2])
    b = _fill(TM.BinaryAUROC(approx=True, device=CPU), stream[2:3])
    c = _fill(TM.BinaryAUROC(approx=True, device=CPU), stream[3:])
    b._score_sketch_fold()  # folded and staged replicas merge alike
    a.merge_state([b, c])
    a._score_sketch_fold()
    solo._score_sketch_fold()
    assert torch.equal(a.sketch_tp, solo.sketch_tp) and torch.equal(a.sketch_fp, solo.sketch_fp)
    assert float(a.compute()) == float(solo.compute())
    a.reset()
    assert int(a.sketch_tp.sum()) == 0 and float(a.compute()) == 0.5
    mc = [TM.MulticlassAUROC(num_classes=4, approx=True, device=CPU) for _ in range(3)]
    rng = np.random.default_rng(3)
    s, lbl = rng.random((1000, 4)).astype(np.float32), rng.integers(0, 4, 1000)
    mc[0].update(s, lbl)
    mc[1].update(s[:600], lbl[:600])
    mc[2].update(s[600:], lbl[600:])
    mc[1].merge_state([mc[2]])
    assert float(mc[1].compute()) == float(mc[0].compute())


def test_int32_edge_fails_closed():
    m = TM.BinaryAUROC(approx=4096, device=CPU)
    big = np.zeros(4096, np.int32)
    big[:4] = 2**29
    m.sketch_tp = torch.from_numpy(big)
    m.sketch_fp = torch.from_numpy(big)
    with pytest.raises(ValueError, match="int32-exact"):
        m.compute()
    m = TM.BinaryAUPRC(approx=4096, device=CPU)
    bad = np.zeros(4096, np.int32)
    bad[7] = -5
    m.sketch_tp = torch.from_numpy(bad)
    with pytest.raises(ValueError, match="int32-exact"):
        m.compute()


def test_knobs_env_and_state_dict(monkeypatch):
    assert tuple(TM.BinaryAUROC(approx=4096, device=CPU).sketch_tp.shape) == (4096,)
    with pytest.raises(ValueError):
        TM.BinaryAUROC(approx=3000, device=CPU)
    monkeypatch.setenv("TORCHEVAL_TPU_APPROX", "1")
    assert TM.BinaryAUROC(device=CPU)._sketch_enabled()
    assert not TM.BinaryAUROC(approx=False, device=CPU)._sketch_enabled()
    assert TM.MulticlassAUPRC(num_classes=3, device=CPU)._sketch_bits == 12
    assert JM.BinaryAUROC()._sketch_enabled()
    monkeypatch.delenv("TORCHEVAL_TPU_APPROX")
    assert not TM.BinaryAUROC(device=CPU)._sketch_enabled()
    m = _fill(TM.BinaryAUROC(approx=True, device=CPU), STREAMS["smooth"])
    sd = m.state_dict()
    assert sorted(sd) == sorted(JM.BinaryAUROC(approx=True).state_dict())
    fresh = TM.BinaryAUROC(approx=True, device=CPU)
    fresh.load_state_dict(sd)
    assert float(fresh.compute()) == float(m.compute())


# ------------------------------------------------------------ PRC curves
def test_binary_prc_approx_matches_jax():
    rng = np.random.default_rng(8)
    s = rng.random(5000).astype(np.float32)
    t = (rng.random(5000) < 0.4).astype(np.float32)
    jm = JM.BinaryPrecisionRecallCurve(approx=True)
    tm = TM.BinaryPrecisionRecallCurve(approx=True, device=CPU)
    for a, b in zip(np.array_split(s, 3), np.array_split(t, 3)):
        jm.update(a, b)
        tm.update(a, b)
    p, r, th = tm.compute()
    for got, want in zip((p, r, th), jm.compute()):
        assert got.shape[0] == want.shape[0]
        _close(got, want)
    assert (torch.diff(th) > 0).all() and float(p[-1]) == 1.0 and float(r[-1]) == 0.0
    exact = TM.BinaryPrecisionRecallCurve(device=CPU).update(s, t).compute()
    assert float(p[0]) == pytest.approx(float(exact[0][0]), abs=1e-6)
    one = TM.BinaryPrecisionRecallCurve(approx=True, device=CPU)
    one.update(np.full(64, np.float32(0.625)), np.ones(64, np.float32))
    assert one.compute()[2].shape[0] == 1
    assert abs(float(one.compute()[2][0]) - 0.625) / 0.625 <= T.relative_error(16)


def test_multiclass_prc_approx_matches_jax_and_needs_num_classes(monkeypatch, caplog):
    with pytest.raises(ValueError, match="num_classes"):
        TM.MulticlassPrecisionRecallCurve(approx=True, device=CPU)
    monkeypatch.setenv("TORCHEVAL_TPU_APPROX", "1")
    with caplog.at_level("WARNING"):
        m = TM.MulticlassPrecisionRecallCurve(device=CPU)  # the env cannot size it: exact
    assert not m._sketch_enabled()
    monkeypatch.delenv("TORCHEVAL_TPU_APPROX")
    rng = np.random.default_rng(4)
    c = 3
    s = rng.random((2000, c)).astype(np.float32)
    lbl = rng.integers(0, c, 2000)
    jm = JM.MulticlassPrecisionRecallCurve(num_classes=c, approx=True)
    tm = TM.MulticlassPrecisionRecallCurve(num_classes=c, approx=True, device=CPU)
    jm.update(s, lbl)
    tm.update(s, lbl)
    for got_list, want_list in zip(tm.compute(), jm.compute()):
        assert len(got_list) == c
        for got, want in zip(got_list, want_list):
            _close(got, want)
    bad = TM.MulticlassPrecisionRecallCurve(num_classes=c, approx=True, device=CPU)
    sb = s.copy()
    sb[0, 1] = np.nan
    bad.update(sb, lbl)
    with pytest.raises(ValueError, match="per-class"):
        bad.compute()


def test_prc_staged_fold_cadence_merge_and_reset():
    rng = np.random.default_rng(6)
    s = rng.random(70_000).astype(np.float32)
    t = (rng.random(70_000) < 0.5).astype(np.float32)
    m = TM.BinaryPrecisionRecallCurve(approx=1024, device=CPU)
    m.update(s[:60_000], t[:60_000])
    assert len(m.inputs) == 1
    m.update(s[60_000:], t[60_000:])  # crosses SKETCH_FOLD_ROWS: folds
    assert m.inputs == [] and int(m.sketch_tp.sum() + m.sketch_fp.sum()) == 70_000
    a = TM.BinaryPrecisionRecallCurve(approx=1024, device=CPU).update(s[:100], t[:100])
    b = TM.BinaryPrecisionRecallCurve(approx=1024, device=CPU).update(s[100:200], t[100:200])
    whole = TM.BinaryPrecisionRecallCurve(approx=1024, device=CPU).update(s[:200], t[:200])
    a.merge_state([b])
    for got, want in zip(a.compute(), whole.compute()):
        assert torch.equal(got, want)
    a.reset()
    assert a.inputs == [] and a._sketch_staged == 0 and int(a.sketch_tp.sum()) == 0


# ------------------------------------------------- switching after construction
def test_enable_metric_approx_matches_the_constructor():
    m = TM.BinaryAUROC(device=CPU)
    assert TC.enable_metric_approx(m, 1024, dry_run=True) and not m._sketch_enabled()
    assert TC.enable_metric_approx(m, 1024) and m._sketch_bits == 10
    assert m._sketch_fold_rows == T.SKETCH_FOLD_ROWS
    assert "summary_scores" not in m.state_names
    ref = TM.BinaryAUROC(approx=1024, device=CPU)
    assert m.state_names == ref.state_names
    s, t = STREAMS["smooth"][0]
    assert float(m.update(s, t).compute()) == float(ref.update(s, t).compute())
    used = TM.BinaryAUROC(device=CPU).update(s, t)
    with pytest.raises(ValueError, match="already holds"):
        TC.enable_metric_approx(used, True)
    with pytest.raises(ValueError, match="num_classes"):
        TC.enable_metric_approx(TM.MulticlassPrecisionRecallCurve(device=CPU), True)
    assert TC.enable_metric_approx(TM.Quantile(device=CPU), True)
    assert not TC.enable_metric_approx(TM.Mean(device=CPU), True)
    with pytest.raises(ValueError, match="dim=0"):
        TC.enable_metric_approx(TM.Cat(dim=1, device=CPU), True)
    hr = TM.HitRate(device=CPU)
    assert TC.enable_metric_approx(hr, True) and hr._sketch_enabled()
    prc = TM.MulticlassPrecisionRecallCurve(num_classes=3, device=CPU)
    assert TC.enable_metric_approx(prc, True) and prc._sketch_bits == 12
    assert TC.enable_metric_approx(TM.BinaryAUROC(device=CPU), None)


# the six score-sketch classes, and the four with a compaction_threshold,
# which then sets their fold cadence
SCORE_SKETCH_CASES = [
    *[(cls, None) for cls in ("BinaryAUROC", "BinaryAUPRC", "MulticlassAUROC", "MulticlassAUPRC",
                              "BinaryPrecisionRecallCurve", "MulticlassPrecisionRecallCurve")],
    *[(cls, 30_000) for cls in ("BinaryAUROC", "BinaryAUPRC", "MulticlassAUROC", "MulticlassAUPRC")],
]


def _same(got, want):
    if isinstance(got, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("cls, threshold", SCORE_SKETCH_CASES)
def test_one_score_sketch_lifecycle_whether_built_or_switched(cls, threshold):
    classes = 3 if cls.startswith("Multiclass") else 1
    kw = {"num_classes": classes} if classes > 1 else {}
    if threshold is not None:
        kw["compaction_threshold"] = threshold
    built = getattr(TM, cls)(approx=True, device=CPU, **kw)
    switched = getattr(TM, cls)(device=CPU, **kw)
    assert TC.enable_metric_approx(switched, True)
    want_sd, got_sd = built.state_dict(), switched.state_dict()
    assert list(got_sd) == list(want_sd) == [
        "inputs", "targets", "sketch_tp", "sketch_fp", "sketch_nan_dropped"]
    for k in ("sketch_tp", "sketch_fp", "sketch_nan_dropped"):
        assert (got_sd[k].dtype, got_sd[k].shape) == (want_sd[k].dtype, want_sd[k].shape)

    gen = torch.Generator().manual_seed(7)

    def batch(n):
        if classes > 1:
            return torch.rand(n, classes, generator=gen), torch.randint(0, classes, (n,), generator=gen)
        return torch.rand(n, generator=gen), (torch.rand(n, generator=gen) < 0.4).float()

    # the staged rows fold when they reach the cadence, not a row before
    cadence = threshold or T.SKETCH_FOLD_ROWS
    head, last = batch(cadence - 1), batch(1)
    for m in (built, switched):
        m.update(*head)
        assert len(m.inputs) == 1 and int(m.sketch_tp.sum() + m.sketch_fp.sum()) == 0
        m.update(*last)
        assert m.inputs == [] and int(m.sketch_tp.sum() + m.sketch_fp.sum()) == cadence * classes
    # merge (a replica's staged rows and resident sketch), load, reset
    extra, other = batch(500), getattr(TM, cls)(approx=True, device=CPU, **kw)
    other.update(*batch(cadence)).update(*batch(700))
    for m in (built, switched):
        m.update(*extra).merge_state([other])
    _same(switched.compute(), built.compute())
    loaded = getattr(TM, cls)(device=CPU, **kw)
    TC.enable_metric_approx(loaded, True)
    loaded.load_state_dict(built.state_dict())
    _same(loaded.compute(), built.compute())
    loaded.update(*batch(cadence - 1200))  # the loaded staged rows count toward the cadence
    assert loaded.inputs == []
    for m in (built, switched):
        m.reset()
        assert m.inputs == [] and int(m.sketch_tp.sum() + m.sketch_fp.sum()) == 0
        m.update(*extra)
    _same(switched.compute(), built.compute())


# ------------------------------------------------- no fallback off the CPU
@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """A machine where the kernels' library is neither built nor buildable,
    and the wrappers believe their tensors are not on the CPU."""

    def no_nvcc():
        raise RuntimeError("nvcc was not found")

    monkeypatch.setattr(_build, "_loaded", _build._Loaded())
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)


def test_sketch_folds_raise_instead_of_falling_back(no_library, obs_on):
    before = launches("segment_sum")
    s = torch.rand(64)
    t = (torch.rand(64) < 0.5).float()
    folds = [
        lambda: T.score_hist_fold(s, t, 10),
        lambda: T.mc_score_hist_fold(torch.rand(8, 3), torch.arange(8) % 3, 10, 3),
        lambda: T.value_hist_fold(s, 10),
        lambda: TC.sliced_score_hist_fold(torch.zeros(64, dtype=torch.int32), s, t, 4, 2),
        lambda: TM.BinaryAUROC(approx=True, device=CPU).update(s, t).compute(),
        lambda: TM.Quantile(device=CPU).update(s).compute(),
        lambda: TM.Cat(approx=True, device=CPU).update(s).compute(),
    ]
    for fold in folds:
        with pytest.raises(RuntimeError, match="nvcc"):
            fold()
    assert launches("segment_sum") == before
