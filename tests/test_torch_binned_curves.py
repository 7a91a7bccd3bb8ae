"""The port's binned precision-recall curves (functional and class metrics)
against the JAX package's, on the CPU.

The JAX package compares every score with every threshold; the port counts
buckets (``searchsorted``) and sums them from the top. The same numpy
inputs, made from a seed, go through both packages (``device="cpu"``, where
the histogram and the segment sum run their plain versions). The counters
``num_tp``/``num_fp``/``num_fn`` must be equal exactly, on every input JAX
accepts: repeated thresholds, thresholds at 0 and 1, -0.0 against 0.0, NaN
and +-inf scores, half-precision scores, and binary targets other than 0/1
(a weight in JAX's product). Precision and recall agree within rtol 1e-5,
atol 1e-8, NaN where JAX has NaN.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu.metrics.functional.classification.binned_precision_recall_curve import (
    _binary_binned_update as jax_binary_update,
)
from torcheval_tpu.metrics.functional.classification.binned_precision_recall_curve import (
    _multiclass_binned_update as jax_multiclass_update,
)
from torcheval_tpu_torch.metrics import (
    BinaryBinnedPrecisionRecallCurve,
    MetricCollection,
    MulticlassAccuracy,
    MulticlassBinnedPrecisionRecallCurve,
)
from torcheval_tpu_torch.metrics.functional import (
    binary_binned_precision_recall_curve,
    multiclass_binned_precision_recall_curve,
)
from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
    _binary_binned_update,
    _create_threshold_tensor,
    _multiclass_binned_update,
)
from torcheval_tpu_torch.utils.jax_state import load_jax_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils import NUM_TOTAL_UPDATES, MetricClassTester
from torcheval_tpu_torch.utils.test_utils.obs_counts import count, folding_window_steps, recording


@pytest.fixture
def obs_on():
    """The obs registry on (and reset) for a test that counts launches,
    folds or rounds: the registry is the port's one counter."""
    with recording():
        yield


CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-8
C = 4
COUNTERS = ("num_tp", "num_fp", "num_fn")
THRESHOLDS = {
    "count_5": 5,
    "count_11": 11,
    "repeated_with_ends": [0.0, 0.0, 0.25, 0.5, 0.5, 0.75, 1.0, 1.0],
    "inner": [0.1, 0.3, 0.35, 0.9, 0.95, 0.99],
}
SPECIALS = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, 0.5, 0.25, 1.5, -0.5], np.float32)


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=RTOL, atol=ATOL,
        equal_nan=True,
    )


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.int32, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _scores(rng, shape, grid=True):
    """Scores on a grid of eighths (hitting the thresholds exactly), with
    NaN, +-inf and signed zeros scattered in."""
    x = rng.integers(-1, 10, shape).astype(np.float32) / 8 if grid else rng.random(shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, min(flat.size, 4 * SPECIALS.size), replace=False)
    flat[idx] = np.resize(SPECIALS, idx.size)
    return x


def _jax_thresholds(spec):
    return jnp.linspace(0.0, 1.0, spec) if isinstance(spec, int) else jnp.asarray(spec, jnp.float32)


# ------------------------------------------------------------- thresholds
def test_threshold_count_equals_jnp_linspace_bit_for_bit():
    for n in list(range(0, 24)) + [100, 101, 257, 1000]:
        got = _create_threshold_tensor(n).numpy()
        want = np.asarray(jnp.linspace(0.0, 1.0, n))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_threshold_checks_match_jax():
    with pytest.raises(ValueError, match="sorted"):
        binary_binned_precision_recall_curve(torch.rand(4), torch.ones(4), threshold=[0.5, 0.2])
    with pytest.raises(ValueError, match="range"):
        BinaryBinnedPrecisionRecallCurve(threshold=[0.2, 1.5], device=CPU)
    with pytest.raises(ValueError, match="at least 2"):
        MulticlassBinnedPrecisionRecallCurve(1, device=CPU)
    with pytest.raises(ValueError, match="num_sample, num_classes"):
        multiclass_binned_precision_recall_curve(torch.rand(4, 3), torch.ones(4), num_classes=4)


# ------------------------------------------------------------------ counts
@pytest.mark.parametrize("spec", list(THRESHOLDS.values()), ids=list(THRESHOLDS))
@pytest.mark.parametrize("targets", ["binary", "weights", "floats", "bool"])
def test_binary_counts_equal_jax(spec, targets):
    rng = np.random.default_rng(1)
    x = _scores(rng, 400)
    t = {
        "binary": (rng.random(400) < 0.4).astype(np.int64),
        "weights": rng.integers(-1, 4, 400).astype(np.int32),  # JAX multiplies by them
        "floats": (rng.random(400) * 2.5).astype(np.float32),  # truncated to int32 first
        "bool": rng.random(400) < 0.3,
    }[targets]
    th = _create_threshold_tensor(spec)
    got = _binary_binned_update(torch.from_numpy(x), torch.from_numpy(t), th)
    want = jax_binary_update(jnp.asarray(x), jnp.asarray(t), _jax_thresholds(spec))
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("spec", list(THRESHOLDS.values()), ids=list(THRESHOLDS))
def test_multiclass_counts_equal_jax(spec):
    rng = np.random.default_rng(2)
    x = _scores(rng, (300, C))
    t = rng.integers(-1, C + 1, 300)  # out-of-range labels match no class
    th = _create_threshold_tensor(spec)
    got = _multiclass_binned_update(torch.from_numpy(x), torch.from_numpy(t), th, C)
    want = jax_multiclass_update(jnp.asarray(x), jnp.asarray(t), _jax_thresholds(spec), C)
    for g, w in zip(got, want):
        assert g.shape == (th.shape[0], C)
        _equal(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_half_precision_scores_compare_in_float32(dtype):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_scores(rng, (200, C), grid=False)).to(dtype)
    t = torch.from_numpy(rng.integers(0, C, 200))
    th = _create_threshold_tensor(7)
    got = _multiclass_binned_update(x, t, th, C)
    # the half values widen exactly, and JAX compares them in float32
    want = jax_multiclass_update(jnp.asarray(x.float().numpy()), jnp.asarray(t.numpy()), _jax_thresholds(7), C)
    for g, w in zip(got, want):
        _equal(g, w)
    gb = _binary_binned_update(x[:, 0], (t == 0).to(torch.int32), th)
    wb = jax_binary_update(jnp.asarray(x[:, 0].float().numpy()), jnp.asarray((t == 0).numpy().astype(np.int32)),
                           _jax_thresholds(7))
    for g, w in zip(gb, wb):
        _equal(g, w)


def test_binned_counts_batch_under_vmap():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_scores(rng, (3, 50, C)))
    t = torch.from_numpy(rng.integers(0, C, (3, 50)))
    th = _create_threshold_tensor(6)
    got = torch.func.vmap(lambda a, b: _multiclass_binned_update(a, b, th, C))(x, t)
    gotb = torch.func.vmap(lambda a, b: _binary_binned_update(a, b, th))(x[..., 0], t)
    for i in range(3):
        for g, w in zip(got, _multiclass_binned_update(x[i], t[i], th, C)):
            assert torch.equal(g[i], w)
        for g, w in zip(gotb, _binary_binned_update(x[i, :, 0], t[i], th)):
            assert torch.equal(g[i], w)


# --------------------------------------------------------------- functional
@pytest.mark.parametrize("spec", [5, [0.0, 0.5, 0.5, 1.0]], ids=["count_5", "repeated"])
def test_functional_binary_matches_jax(spec):
    rng = np.random.default_rng(5)
    x = _scores(rng, 300)
    t = (rng.random(300) < 0.4).astype(np.float32)
    got = binary_binned_precision_recall_curve(x, t, threshold=spec)
    want = JF.binary_binned_precision_recall_curve(x, t, threshold=spec)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def test_functional_binary_without_positives_or_predictions():
    # precision 1.0 where nothing is predicted, recall NaN with no positives
    x = np.full(10, 0.05, np.float32)
    t = np.zeros(10, np.float32)
    got = binary_binned_precision_recall_curve(x, t, threshold=5)
    want = JF.binary_binned_precision_recall_curve(x, t, threshold=5)
    for g, w in zip(got, want):
        _close(g, w)
    assert torch.isnan(got[1][:-1]).all() and (got[0][1:] == 1.0).all()


@pytest.mark.parametrize("num_classes", [None, C], ids=str)
def test_functional_multiclass_matches_jax(num_classes):
    rng = np.random.default_rng(6)
    x = _scores(rng, (250, C))
    t = rng.integers(0, C - 1, 250)  # the last class never labelled: recall NaN
    got = multiclass_binned_precision_recall_curve(x, t, num_classes=num_classes, threshold=9)
    want = JF.multiclass_binned_precision_recall_curve(x, t, num_classes=num_classes, threshold=9)
    assert len(got[0]) == len(got[1]) == C
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        _close(g, w)
    _close(got[2], want[2])


# ------------------------------------------------------------- class metrics
def _stream(seed, classes=None, n=NUM_TOTAL_UPDATES, batch=20):
    rng = np.random.default_rng(seed)
    if classes is None:
        return _scores(rng, (n, batch)), (rng.random((n, batch)) < 0.4).astype(np.int64)
    return _scores(rng, (n, batch, classes)), rng.integers(0, classes, (n, batch))


class TestBinnedClasses(MetricClassTester):
    def _run(self, port, ref, update_kwargs, expected):
        self.run_class_implementation_tests(
            metric=port,
            state_names={"threshold", *COUNTERS},
            update_kwargs=update_kwargs,
            compute_result=expected,
            atol=ATOL,
            rtol=RTOL,
        )
        stream = copy.deepcopy(port)
        for i in range(NUM_TOTAL_UPDATES):
            stream.update(**{k: v[i] for k, v in update_kwargs.items()})
        got, want = stream.state_dict(), ref.state_dict()
        for name in COUNTERS:
            _equal(got[name], want[name])
        _close(got["threshold"], want["threshold"])

    def test_binary(self):
        x, t = _stream(seed=7)
        for spec in (5, THRESHOLDS["repeated_with_ends"]):
            with self.subTest(spec=spec):
                ref = J.BinaryBinnedPrecisionRecallCurve(threshold=spec)
                for i in range(NUM_TOTAL_UPDATES):
                    ref.update(x[i], t[i])
                expected = tuple(torch.from_numpy(np.array(v)) for v in ref.compute())
                self._run(BinaryBinnedPrecisionRecallCurve(threshold=spec, device=CPU), ref,
                          {"input": torch.from_numpy(x), "target": torch.from_numpy(t)}, expected)

    def test_multiclass(self):
        x, t = _stream(seed=8, classes=C)
        ref = J.MulticlassBinnedPrecisionRecallCurve(C, threshold=7)
        for i in range(NUM_TOTAL_UPDATES):
            ref.update(x[i], t[i])
        p, r, th = ref.compute()
        expected = (
            [torch.from_numpy(np.array(v)) for v in p],
            [torch.from_numpy(np.array(v)) for v in r],
            torch.from_numpy(np.array(th)),
        )
        self._run(MulticlassBinnedPrecisionRecallCurve(C, threshold=7, device=CPU), ref,
                  {"input": torch.from_numpy(x), "target": torch.from_numpy(t)}, expected)


def test_empty_metrics_match_jax():
    for port, ref in (
        (BinaryBinnedPrecisionRecallCurve(threshold=5, device=CPU), J.BinaryBinnedPrecisionRecallCurve(threshold=5)),
        (MulticlassBinnedPrecisionRecallCurve(3, threshold=5, device=CPU),
         J.MulticlassBinnedPrecisionRecallCurve(3, threshold=5)),
    ):
        got, want = port.compute(), ref.compute()
        for g, w in zip(got[:2], want[:2]):
            _close(torch.stack(list(g)) if isinstance(g, list) else g,
                   np.stack([np.asarray(v) for v in w]) if isinstance(w, list) else w)


def test_window_stacks_the_batches_under_vmap(obs_on):
    # uniform batches of a per-chunk fold: one stacked, vmapped fold a window
    x, t = _stream(seed=9, classes=C)
    col = MetricCollection({
        "binned": MulticlassBinnedPrecisionRecallCurve(C, threshold=6, device=CPU),
        "acc": MulticlassAccuracy(num_classes=C, average="macro", device=CPU),
    })
    ref = J.MulticlassBinnedPrecisionRecallCurve(C, threshold=6)
    alone = BinaryBinnedPrecisionRecallCurve(threshold=6, device=CPU)
    ref_alone = J.BinaryBinnedPrecisionRecallCurve(threshold=6)
    before = (folding_window_steps(), count("deferred.window_step_batches"))
    for i in range(NUM_TOTAL_UPDATES):
        col.update(torch.from_numpy(x[i]), torch.from_numpy(t[i]))
        ref.update(x[i], t[i])
        alone.update(torch.from_numpy(x[i, :, 0]), torch.from_numpy((t[i] == 0).astype(np.int32)))
        ref_alone.update(x[i, :, 0], (t[i] == 0).astype(np.int32))
    out = col.compute()
    assert (folding_window_steps(), count("deferred.window_step_batches")) == (before[0] + 1, before[1] + NUM_TOTAL_UPDATES)
    got = col["binned"].state_dict()
    for name in COUNTERS:
        _equal(got[name], ref.state_dict()[name])
    for g, w in zip(out["binned"][0] + out["binned"][1], ref.compute()[0] + ref.compute()[1]):
        _close(g, w)
    assert len(alone._pending) == NUM_TOTAL_UPDATES  # stacked at the read
    for name in COUNTERS:
        _equal(alone.state_dict()[name], ref_alone.state_dict()[name])


def test_state_dict_mid_window_and_carried_both_ways():
    x, t = _stream(seed=10, classes=C)
    half = NUM_TOTAL_UPDATES // 2
    whole = J.MulticlassBinnedPrecisionRecallCurve(C, threshold=5)
    for i in range(NUM_TOTAL_UPDATES):
        whole.update(x[i], t[i])
    port = MulticlassBinnedPrecisionRecallCurve(C, threshold=5, device=CPU)
    j = J.MulticlassBinnedPrecisionRecallCurve(C, threshold=5)
    for i in range(half):
        port.update(x[i], t[i])
        j.update(x[i], t[i])
    assert port._pending
    for name in COUNTERS:
        _equal(port.state_dict()[name], j.state_dict()[name])
    there = MulticlassBinnedPrecisionRecallCurve(C, threshold=5, device=CPU)
    load_jax_state_dict(there, {k: np.asarray(v) for k, v in j.state_dict().items()})
    back = J.MulticlassBinnedPrecisionRecallCurve(C, threshold=5)
    back.load_state_dict(numpy_state_dict(port))
    for i in range(half, NUM_TOTAL_UPDATES):
        there.update(x[i], t[i])
        back.update(x[i], t[i])
    for name in COUNTERS:
        _equal(there.state_dict()[name], whole.state_dict()[name])
        _equal(np.asarray(back.state_dict()[name]), whole.state_dict()[name])
