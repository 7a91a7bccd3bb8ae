"""The port's exact precision-recall curves (``ops/curves.py::prc_points_kernel``,
the functional and class metrics) against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both packages. The
curves have one point per distinct threshold, so the lengths must be
equal; thresholds equal exactly, precision and recall within rtol 1e-5,
atol 1e-8. Scores carry ties, +-inf and -0.0 beside 0.0 (one tie group,
whose threshold may keep either sign). NaN scores are left out: they are
the compacting metrics' padding, and the two packages sort them to
opposite ends.
"""

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu_torch.metrics import BinaryPrecisionRecallCurve, MulticlassPrecisionRecallCurve
from torcheval_tpu_torch.metrics.functional import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
)
from torcheval_tpu_torch.ops.curves import class_onehot_rows, prc_points_kernel
from torcheval_tpu_torch.utils.test_utils import NUM_TOTAL_UPDATES, MetricClassTester

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-8
C = 4


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=RTOL, atol=ATOL
    )


def _curve_equal(got, want):
    p, r, t = got
    assert p.shape == np.asarray(want[0]).shape and t.shape == np.asarray(want[2]).shape
    _close(p, want[0])
    _close(r, want[1])
    np.testing.assert_array_equal(t.numpy(), np.asarray(want[2]))  # -0.0 == 0.0


def _scores(rng, shape):
    x = (rng.integers(-2, 40, shape) / 37.0).astype(np.float32)  # ties
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, 8, replace=False)
    flat[idx] = np.array([np.inf, -np.inf, -0.0, 0.0, -0.0, 0.0, np.inf, -np.inf], np.float32)
    return x


@pytest.mark.parametrize("positives", ["some", "none", "all"])
def test_functional_binary_matches_jax(positives):
    rng = np.random.default_rng(1)
    x = _scores(rng, 300)
    t = {"some": rng.random(300) < 0.4, "none": np.zeros(300, bool), "all": np.ones(300, bool)}[positives]
    t = t.astype(np.float32)
    got = binary_precision_recall_curve(x, t)
    _curve_equal(got, JF.binary_precision_recall_curve(x, t))
    if positives == "none":  # recall 1.0 with no positives, then the origin point
        assert (got[1][:-1] == 1.0).all() and float(got[1][-1]) == 0.0


def test_points_and_group_ends():
    s, p, r, last = prc_points_kernel(torch.tensor([0.9, 0.5, 0.5, 0.1]), torch.tensor([1, 0, 1, 0]))
    assert s.tolist() == [0.8999999761581421, 0.5, 0.5, 0.10000000149011612]
    assert last.tolist() == [True, False, True, True]
    _close(p[last], [1.0, 2 / 3, 0.5])
    _close(r[last], [0.5, 1.0, 1.0])


def test_empty_input():
    got = binary_precision_recall_curve(torch.empty(0), torch.empty(0))
    want = JF.binary_precision_recall_curve(np.empty(0, np.float32), np.empty(0, np.float32))
    _curve_equal(got, want)


@pytest.mark.parametrize("num_classes", [None, C], ids=str)
def test_functional_multiclass_matches_jax(num_classes):
    rng = np.random.default_rng(2)
    x = _scores(rng, (200, C))
    t = rng.integers(-1, C, 200)  # label -1 matches no class; class C-1 may be rare
    t[t == 2] = 1  # class 2 has no positives
    got = multiclass_precision_recall_curve(x, t, num_classes=num_classes)
    want = JF.multiclass_precision_recall_curve(x, t, num_classes=num_classes)
    assert all(len(g) == C for g in got)
    for c in range(C):
        _curve_equal([g[c] for g in got], [w[c] for w in want])


def test_a_tie_never_crosses_class_rows():
    # class 0's lowest score is class 1's highest: in the (C, N) rows the
    # first row ends where the next starts
    rng = np.random.default_rng(3)
    x = np.stack([0.5 + rng.integers(0, 5, 50) / 10, rng.integers(0, 6, 50) / 10], axis=1).astype(np.float32)
    x[0, 0], x[1, 1] = 0.5, 0.5
    t = rng.integers(0, 2, 50)
    got = multiclass_precision_recall_curve(x, t)
    want = JF.multiclass_precision_recall_curve(x, t)
    for c in range(2):
        _curve_equal([g[c] for g in got], [w[c] for w in want])
    assert class_onehot_rows(torch.tensor([1.7, 0.0, 3.0]), 2).tolist() == [[0, 1, 0], [1, 0, 0]]


def test_input_checks_match_jax():
    with pytest.raises(ValueError, match="one-dimensional"):
        binary_precision_recall_curve(torch.zeros(4, 2), torch.zeros(4))
    with pytest.raises(ValueError, match="same shape"):
        binary_precision_recall_curve(torch.zeros(4), torch.zeros(3))
    with pytest.raises(ValueError, match="num_sample, num_classes"):
        multiclass_precision_recall_curve(torch.zeros(4), torch.zeros(4))
    with pytest.raises(ValueError, match="first dimension"):
        MulticlassPrecisionRecallCurve(device=CPU).update(torch.zeros(4, 2), torch.zeros(3))


class TestCurveClasses(MetricClassTester):
    def test_binary(self):
        rng = np.random.default_rng(4)
        x = _scores(rng, (NUM_TOTAL_UPDATES, 24))
        t = (rng.random((NUM_TOTAL_UPDATES, 24)) < 0.4).astype(np.float32)
        want = JF.binary_precision_recall_curve(x.reshape(-1), t.reshape(-1))
        self.run_class_implementation_tests(
            metric=BinaryPrecisionRecallCurve(device=CPU),
            state_names={"inputs", "targets"},
            update_kwargs={"input": torch.from_numpy(x), "target": torch.from_numpy(t)},
            compute_result=tuple(torch.from_numpy(np.array(w)) for w in want),
            atol=ATOL,
            rtol=RTOL,
        )

    def test_multiclass(self):
        rng = np.random.default_rng(5)
        x = _scores(rng, (NUM_TOTAL_UPDATES, 24, C))
        t = rng.integers(0, C, (NUM_TOTAL_UPDATES, 24))
        ref = J.MulticlassPrecisionRecallCurve(num_classes=C)
        for i in range(NUM_TOTAL_UPDATES):
            ref.update(x[i], t[i])
        want = tuple([torch.from_numpy(np.array(v)) for v in part] for part in ref.compute())
        self.run_class_implementation_tests(
            metric=MulticlassPrecisionRecallCurve(device=CPU),
            state_names={"inputs", "targets"},
            update_kwargs={"input": torch.from_numpy(x), "target": torch.from_numpy(t)},
            compute_result=want,
            atol=ATOL,
            rtol=RTOL,
        )


def test_empty_metrics():
    p, r, t = BinaryPrecisionRecallCurve(device=CPU).compute()
    assert p.numel() == r.numel() == t.numel() == 0
    assert MulticlassPrecisionRecallCurve(num_classes=3, device=CPU).compute() == ([], [], [])
    assert J.MulticlassPrecisionRecallCurve(num_classes=3).compute() == ([], [], [])
