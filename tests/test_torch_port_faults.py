"""Faults found in the port by comparing it with the JAX package, each held
to the JAX package on the input that showed it (the catalogue is
``ROADMAP.md`` Queue 3).

1. An exact precision-recall curve with one distinct threshold raised in
   ``torch.from_numpy`` (a one-element reversed numpy view keeps its
   negative stride through ``np.ascontiguousarray``).
2. NaN-scored rows were ordered by an unstable sort. Every NaN row is a tie
   group of its own (NaN != NaN), so their order moves the curve; the JAX
   package sorts with ``jax.lax.sort``, which is stable. The search below
   covers 17 to 64 rows: no mismatch showed below 17.

The third fault (``torcheval_tpu_torch.ops`` exported nothing) is held by
``tests/test_torch_ops_exports.py``. Values within rtol 1e-5, atol 1e-8;
thresholds and curve lengths exactly.
"""

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.metrics.functional as JF
import torcheval_tpu_torch.metrics as P
import torcheval_tpu_torch.metrics.functional as PF

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-8

# ROADMAP Queue 3, item 2: JAX 0.31667 / 0.27323, the unstable port 0.3 / 0.26942.
NAN17_SCORES = np.array(
    [np.nan, .2301, np.nan, .4934, .2338, .2528, .4733, .7333, np.nan, .4987,
     .4433, .3792, .8215, .5761, np.nan, .5482, .1989],
    np.float32,
)
NAN17_TARGETS = np.array([1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 1, 0, 1])


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=RTOL, atol=ATOL
    )


def _curve_equal(got, want):
    p, r, t = (np.asarray(a) for a in got)
    wp, wr, wt = (np.asarray(a) for a in want)
    assert p.shape == wp.shape and t.shape == wt.shape
    _close(p, wp)
    _close(r, wr)
    np.testing.assert_array_equal(t, wt)


def _curves_equal(got, want):
    assert len(got[0]) == len(want[0])
    for c in range(len(got[0])):
        _curve_equal([x[c] for x in got], [x[c] for x in want])


# --- 1. one threshold -------------------------------------------------------

ONE_THRESHOLD_BINARY = {
    "one_sample": (np.array([0.7], np.float32), np.array([1])),
    "tied_pair": (np.array([0.7, 0.7], np.float32), np.array([1, 0])),
    "all_tied": (np.full(9, 0.25, np.float32), np.array([1, 0, 0, 1, 1, 0, 1, 0, 0])),
}


@pytest.mark.parametrize("case", sorted(ONE_THRESHOLD_BINARY))
def test_one_threshold_binary_functional(case):
    x, t = ONE_THRESHOLD_BINARY[case]
    got = PF.binary_precision_recall_curve(torch.from_numpy(x), torch.from_numpy(t))
    want = JF.binary_precision_recall_curve(x, t)
    _curve_equal(got, want)
    assert all(a.is_contiguous() for a in got)


def test_one_threshold_values_are_the_roadmaps():
    p, r, t = PF.binary_precision_recall_curve(torch.tensor([0.7]), torch.tensor([1]))
    assert p.tolist() == [1.0, 1.0] and r.tolist() == [1.0, 0.0]
    np.testing.assert_array_equal(t.numpy(), np.array([0.7], np.float32))
    p, r, t = PF.binary_precision_recall_curve(torch.tensor([0.7, 0.7]), torch.tensor([1, 0]))
    assert p.tolist() == [0.5, 1.0] and r.tolist() == [1.0, 0.0]


@pytest.mark.parametrize("case", sorted(ONE_THRESHOLD_BINARY))
def test_one_threshold_binary_class(case):
    x, t = ONE_THRESHOLD_BINARY[case]
    m = P.BinaryPrecisionRecallCurve(device=CPU)
    m.update(torch.from_numpy(x), torch.from_numpy(t))
    jm = J.BinaryPrecisionRecallCurve()
    jm.update(x, t)
    _curve_equal(m.compute(), jm.compute())


def _one_threshold_multiclass(case):
    C = 4
    if case == "one_sample":
        return np.array([[0.1, 0.6, 0.2, 0.1]], np.float32), np.array([1]), C
    if case == "all_tied":
        return np.full((6, C), 0.25, np.float32), np.array([0, 1, 2, 3, 1, 0]), C
    rng = np.random.default_rng(3)  # "tied_column": class 2's column is one score
    x = rng.random((12, C)).astype(np.float32)
    x[:, 2] = 0.5
    return x, rng.integers(0, C, 12), C


@pytest.mark.parametrize("case", ["one_sample", "all_tied", "tied_column"])
def test_one_threshold_multiclass_functional(case):
    x, t, C = _one_threshold_multiclass(case)
    got = PF.multiclass_precision_recall_curve(torch.from_numpy(x), torch.from_numpy(t), num_classes=C)
    want = JF.multiclass_precision_recall_curve(x, t, num_classes=C)
    _curves_equal(got, want)


@pytest.mark.parametrize("case", ["one_sample", "all_tied", "tied_column"])
def test_one_threshold_multiclass_class(case):
    x, t, C = _one_threshold_multiclass(case)
    m = P.MulticlassPrecisionRecallCurve(num_classes=C, device=CPU)
    m.update(torch.from_numpy(x), torch.from_numpy(t))
    jm = J.MulticlassPrecisionRecallCurve(num_classes=C)
    jm.update(x, t)
    _curves_equal(m.compute(), jm.compute())


# --- 2. NaN rows in a stable order ------------------------------------------

def test_nan17_values_are_the_roadmaps():
    x, t = torch.from_numpy(NAN17_SCORES), torch.from_numpy(NAN17_TARGETS)
    np.testing.assert_allclose(float(PF.binary_auroc(x, t)), 0.31667, atol=5e-6)
    np.testing.assert_allclose(float(PF.binary_auprc(x, t)), 0.27323, atol=5e-6)


def _nan_inputs():
    """The 17-row input, then 24 seeded draws of 17 to 64 rows with about a
    fifth of the scores NaN and ties among the rest."""
    yield "nan17", NAN17_SCORES, NAN17_TARGETS
    rng = np.random.default_rng(16)
    for i in range(24):
        n = int(rng.integers(17, 65))
        x = (rng.integers(0, 30, n) / 29.0).astype(np.float32)
        x[rng.random(n) < 0.2] = np.nan
        yield f"draw{i}_n{n}", x, rng.integers(0, 2, n)


NAN_CASES = list(_nan_inputs())


@pytest.mark.parametrize("name,x,t", NAN_CASES, ids=[c[0] for c in NAN_CASES])
def test_nan_rows_binary_functionals(name, x, t):
    px, pt = torch.from_numpy(x), torch.from_numpy(t)
    _close(PF.binary_auroc(px, pt), JF.binary_auroc(x, t))
    _close(PF.binary_auprc(px, pt), JF.binary_auprc(x, t))
    p, r, th = PF.binary_precision_recall_curve(px, pt)
    wp, wr, wth = JF.binary_precision_recall_curve(x, t)
    _close(p, wp)
    _close(r, wr)
    np.testing.assert_array_equal(th.numpy(), np.asarray(wth))  # NaN == NaN here


@pytest.mark.parametrize("name,x,t", NAN_CASES[:9], ids=[c[0] for c in NAN_CASES[:9]])
def test_nan_rows_binary_classes(name, x, t):
    for P_cls, J_cls in ((P.BinaryAUROC, J.BinaryAUROC), (P.BinaryAUPRC, J.BinaryAUPRC)):
        m, jm = P_cls(device=CPU), J_cls()
        half = len(x) // 2
        for sl in (slice(0, half), slice(half, None)):
            m.update(torch.from_numpy(x[sl]), torch.from_numpy(t[sl]))
            jm.update(x[sl], t[sl])
        _close(m.compute(), jm.compute())


def _multiclass_nan(seed):
    rng = np.random.default_rng(seed)
    n, C = int(rng.integers(17, 65)), 3
    x = (rng.integers(0, 20, (n, C)) / 19.0).astype(np.float32)
    x[rng.random((n, C)) < 0.2] = np.nan
    return x, rng.integers(0, C, n), C


@pytest.mark.parametrize("seed", range(8))
def test_nan_rows_multiclass_functionals(seed):
    x, t, C = _multiclass_nan(seed)
    px, pt = torch.from_numpy(x), torch.from_numpy(t)
    for avg in ("macro", None):
        _close(
            PF.multiclass_auroc(px, pt, num_classes=C, average=avg),
            JF.multiclass_auroc(x, t, num_classes=C, average=avg),
        )
        _close(
            PF.multiclass_auprc(px, pt, num_classes=C, average=avg),
            JF.multiclass_auprc(x, t, num_classes=C, average=avg),
        )
    got = PF.multiclass_precision_recall_curve(px, pt, num_classes=C)
    want = JF.multiclass_precision_recall_curve(x, t, num_classes=C)
    assert len(got[0]) == len(want[0])
    for c in range(C):
        _close(got[0][c], want[0][c])
        _close(got[1][c], want[1][c])
        np.testing.assert_array_equal(got[2][c].numpy(), np.asarray(want[2][c]))
