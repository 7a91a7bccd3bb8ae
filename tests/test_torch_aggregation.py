"""The port's aggregation and regression metrics and ``MetricCollection``
against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through ``torcheval_tpu`` and
``torcheval_tpu_torch`` (``device="cpu"``). Counts and extrema are compared
exactly; float sums and means within the repo's tolerance (rtol 1e-5,
atol 1e-8), since the two packages add in different orders.
"""

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu_torch.metrics import (
    BinaryAccuracy,
    Max,
    Mean,
    MeanSquaredError,
    MetricCollection,
    Min,
    MulticlassAccuracy,
    Sum,
)
from torcheval_tpu_torch.metrics.functional import mean, mean_squared_error, sum as tsum

RTOL, ATOL = 1e-5, 1e-8
CPU = "cpu"


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
        rtol=RTOL, atol=ATOL, equal_nan=True,
    )


def _chunks(seed=0, n=4, size=97, shape=()):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((size,) + shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("weight", ["default", "scalar", "array"])
def test_functional_sum_and_mean_match_jax(weight):
    x = _chunks(n=1)[0]
    w = {"default": 1.0, "scalar": 0.25, "array": np.abs(_chunks(seed=1, n=1)[0])}[weight]
    _close(tsum(x, w), JF.sum(x, w))
    _close(mean(x, w), JF.mean(x, w))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize(
    "make_torch,make_jax",
    [(lambda: Sum(device=CPU), J.Sum), (lambda: Mean(device=CPU), J.Mean)],
    ids=["sum", "mean"],
)
def test_sum_and_mean_stream_and_merge_like_jax(make_torch, make_jax, weighted):
    chunks = _chunks(seed=2)
    weights = [np.abs(c) + 0.5 for c in _chunks(seed=3)]
    a, b, ja = make_torch(), make_torch(), make_jax()
    for i, (x, w) in enumerate(zip(chunks, weights)):
        kw = {"weight": w} if weighted else {}
        (a if i % 2 else b).update(x, **kw)
        ja.update(x, **kw)
    a.merge_state([b])
    _close(a.compute(), ja.compute())
    for name, value in a.state_dict().items():
        assert value.dtype == torch.float32
        _close(value, np.asarray(ja.state_dict()[name]))


def test_mean_of_zero_weights_is_zero_like_jax():
    x = np.asarray([1.0, -2.0], np.float32)
    m, jm = Mean(device=CPU), J.Mean()
    m.update(x, weight=0.0)
    jm.update(x, weight=0.0)
    _close(m.compute(), jm.compute())
    # zero-mean data is not mistaken for no data (the reference's bug)
    z, jz = Mean(device=CPU), J.Mean()
    z.update(np.asarray([1.0, -1.0], np.float32))
    jz.update(np.asarray([1.0, -1.0], np.float32))
    assert float(z.compute()) == float(jz.compute()) == 0.0
    assert float(z.weights) == 2.0


@pytest.mark.parametrize(
    "make_torch,make_jax",
    [(lambda: Max(device=CPU), J.Max), (lambda: Min(device=CPU), J.Min)],
    ids=["max", "min"],
)
def test_extrema_stream_merge_and_reset_like_jax(make_torch, make_jax):
    chunks = _chunks(seed=4, shape=(3,))
    a, b, ja = make_torch(), make_torch(), make_jax()
    assert float(a.compute()) == float(ja.compute())  # -inf or +inf before any update
    for i, x in enumerate(chunks):
        (a if i % 2 else b).update(x)
        ja.update(x)
    a.merge_state([b])
    assert float(a.compute()) == float(ja.compute())
    a.update(np.asarray([3, -7], np.int32))  # integers widen to the float state
    ja.update(np.asarray([3, -7], np.int32))
    assert a.compute().dtype == torch.float32
    assert float(a.compute()) == float(ja.compute())
    a.reset()
    assert float(a.compute()) == float(make_jax().compute())


@pytest.mark.parametrize("multioutput", ["uniform_average", "raw_values"])
@pytest.mark.parametrize("shape", [(), (3,)])
@pytest.mark.parametrize("weighted", [False, True])
def test_mse_matches_jax(multioutput, shape, weighted):
    xs, ts = _chunks(seed=5, shape=shape), _chunks(seed=6, shape=shape)
    ws = [np.abs(w) for w in _chunks(seed=7)]
    m, other, jm = (
        MeanSquaredError(multioutput=multioutput, device=CPU),
        MeanSquaredError(multioutput=multioutput, device=CPU),
        J.MeanSquaredError(multioutput=multioutput),
    )
    for i, (x, t, w) in enumerate(zip(xs, ts, ws)):
        kw = {"sample_weight": w} if weighted else {}
        (m if i % 2 else other).update(x, t, **kw)
        jm.update(x, t, **kw)
    m.merge_state([other])
    _close(m.compute(), jm.compute())
    jsd = jm.state_dict()
    for name, value in m.state_dict().items():
        assert value.dtype == torch.from_numpy(np.array(jsd[name])).dtype, name
        _close(value, np.asarray(jsd[name]))
    kw = {"sample_weight": ws[0]} if weighted else {}
    _close(
        mean_squared_error(xs[0], ts[0], multioutput=multioutput, **kw),
        JF.mean_squared_error(xs[0], ts[0], multioutput=multioutput, **kw),
    )


def test_mse_validation_errors():
    with pytest.raises(ValueError, match="multioutput"):
        MeanSquaredError(multioutput="median", device=CPU)
    m = MeanSquaredError(device=CPU)
    with pytest.raises(ValueError, match="same size"):
        m.update(np.zeros(3, np.float32), np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="1D or 2D"):
        m.update(np.zeros((2, 2, 2), np.float32), np.zeros((2, 2, 2), np.float32))
    with pytest.raises(ValueError, match="one-dimensional"):
        m.update(np.zeros(3, np.float32), np.zeros(3, np.float32), sample_weight=np.ones((3, 1)))
    with pytest.raises(ValueError, match="first dimension"):
        m.update(np.zeros(3, np.float32), np.zeros(3, np.float32), sample_weight=np.ones(4))
    with pytest.raises(ValueError, match="weight must be"):
        Sum(device=CPU).update(np.zeros(3, np.float32), weight=np.ones(4, np.float32))


def _accuracy_stream(seed=8):
    rng = np.random.default_rng(seed)
    return [
        (rng.random((200, 4)).astype(np.float32), rng.integers(0, 4, 200)) for _ in range(3)
    ]


def test_collection_fans_out_like_jax():
    batches = _accuracy_stream()
    col = MetricCollection({
        "micro": MulticlassAccuracy(num_classes=4, device=CPU),
        "macro": MulticlassAccuracy(average="macro", num_classes=4, device=CPU),
    })
    jcol = J.MetricCollection({
        "micro": J.MulticlassAccuracy(num_classes=4),
        "macro": J.MulticlassAccuracy(average="macro", num_classes=4),
    })
    for scores, labels in batches:
        col.update(scores, labels)
        jcol.update(scores, labels)
    got, want = col.compute(), jcol.compute()
    assert list(got) == ["micro", "macro"]
    for key in got:
        _close(got[key], want[key])
    assert col["micro"] is col.metrics["micro"]
    assert "micro" in repr(col)
    # one member: compute returns its result alone
    single = MetricCollection(BinaryAccuracy(device=CPU))
    single.update(np.asarray([0.9, 0.2], np.float32), np.asarray([1.0, 1.0], np.float32))
    assert float(single.compute()) == 0.5
    with pytest.raises(ValueError):
        MetricCollection({})


def test_collection_state_dicts_round_trip_and_reset():
    batches = _accuracy_stream(seed=9)
    col = MetricCollection({"acc": MulticlassAccuracy(num_classes=4, device=CPU)})
    for scores, labels in batches:
        col.update(scores, labels)
    sd = col.state_dicts()
    fresh = MetricCollection({"acc": MulticlassAccuracy(num_classes=4, device=CPU)})
    fresh.load_state_dicts(sd)
    assert float(fresh.compute()["acc"]) == float(col.compute()["acc"])
    with pytest.raises(RuntimeError, match="missing metric keys"):
        fresh.load_state_dicts({})
    fresh.load_state_dicts({}, strict=False)  # nothing to install
    col.reset()
    assert int(col["acc"].num_total) == 0
