"""The port's click-through rate and weighted calibration (functional,
class and windowed forms) against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through ``torcheval_tpu`` and
``torcheval_tpu_torch`` (``device="cpu"``). Values within atol 1e-8 /
rtol 1e-5 (the packages add float32 in different orders); window lengths
and the JAX package's error messages exactly.
"""

import pickle

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu_torch.metrics import (
    ClickThroughRate,
    MetricCollection,
    WeightedCalibration,
    WindowedClickThroughRate,
    WindowedWeightedCalibration,
)
from torcheval_tpu_torch.metrics.functional import click_through_rate, weighted_calibration

RTOL, ATOL = 1e-5, 1e-8
CPU = "cpu"


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


def _batch(seed, num_tasks, n=53):
    rng = np.random.default_rng(seed)
    shape = (n,) if num_tasks == 1 else (num_tasks, n)
    clicks = (rng.random(shape) < 0.3).astype(np.float32)
    probs = rng.random(shape).astype(np.float32)
    w = (rng.random(shape) * 2).astype(np.float32)
    return clicks, probs, w


def _weight(kind, w):
    return {"none": None, "scalar": 0.5, "int": 2, "array": w, "list": w.tolist()}[kind]


WEIGHTS = ["none", "scalar", "int", "array", "list"]


# ------------------------------------------------------------ functional
@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("num_tasks", [1, 3])
def test_functional_ctr_matches_jax(num_tasks, weights):
    clicks, _, w = _batch(1, num_tasks)
    wt = _weight(weights, w)
    got = click_through_rate(clicks, wt, num_tasks=num_tasks)
    _close(got, JF.click_through_rate(clicks, wt, num_tasks=num_tasks))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("num_tasks", [1, 3])
def test_functional_calibration_matches_jax(num_tasks, weights):
    clicks, probs, w = _batch(2, num_tasks)
    wt = _weight(weights, w)
    got = weighted_calibration(probs, clicks, wt, num_tasks=num_tasks)
    _close(got, JF.weighted_calibration(probs, clicks, wt, num_tasks=num_tasks))


def test_zero_denominators_give_zero_like_jax():
    z = np.zeros(8, np.float32)
    assert float(click_through_rate(z, z)) == 0.0 == float(JF.click_through_rate(z, z))
    assert float(weighted_calibration(np.ones(8, np.float32), z)) == 0.0
    assert float(JF.weighted_calibration(np.ones(8, np.float32), z)) == 0.0


def _raises_like_jax(port_call, jax_call):
    with pytest.raises(ValueError) as jax_err:
        jax_call()
    with pytest.raises(ValueError) as port_err:
        port_call()
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("case", ["weights_shape", "one_task_2d", "tasks_1d", "tasks_rows"])
def test_functional_ctr_errors_match_jax(case):
    clicks, _, w = _batch(3, 3)
    args = {
        "weights_shape": (clicks, w[:, :10], 3),
        "one_task_2d": (clicks, None, 1),
        "tasks_1d": (clicks[0], None, 3),
        "tasks_rows": (clicks, None, 2),
    }[case]
    _raises_like_jax(lambda: click_through_rate(args[0], args[1], num_tasks=args[2]),
                     lambda: JF.click_through_rate(args[0], args[1], num_tasks=args[2]))


@pytest.mark.parametrize("case", ["target_shape", "weight_shape", "tasks"])
def test_functional_calibration_errors_match_jax(case):
    clicks, probs, w = _batch(4, 3)
    args = {
        "target_shape": (probs, clicks[:2], None, 3),
        "weight_shape": (probs, clicks, w[:2], 3),
        "tasks": (probs, clicks, None, 4),
    }[case]
    _raises_like_jax(lambda: weighted_calibration(*args[:3], num_tasks=args[3]),
                     lambda: JF.weighted_calibration(*args[:3], num_tasks=args[3]))


# ----------------------------------------------------------------- classes
@pytest.mark.parametrize("weights", ["none", "scalar", "array"])
@pytest.mark.parametrize("num_tasks", [1, 3])
def test_ctr_streams_and_merges_like_jax(num_tasks, weights):
    a, b = ClickThroughRate(num_tasks=num_tasks, device=CPU), ClickThroughRate(num_tasks=num_tasks, device=CPU)
    ja, jb = J.ClickThroughRate(num_tasks=num_tasks), J.ClickThroughRate(num_tasks=num_tasks)
    for i in range(6):
        clicks, _, w = _batch(10 + i, num_tasks)
        wt = _weight(weights, w)
        (a if i % 2 else b).update(clicks, wt)
        (ja if i % 2 else jb).update(clicks, wt)
    _close(b.compute(), jb.compute())
    a.merge_state([b])
    ja.merge_state([jb])
    _close(a.compute(), ja.compute())
    for name, value in a.state_dict().items():
        assert value.shape == (num_tasks,)
        _close(value, np.asarray(ja.state_dict()[name]))


@pytest.mark.parametrize("weights", ["none", "scalar", "array"])
@pytest.mark.parametrize("num_tasks", [1, 3])
def test_calibration_streams_and_merges_like_jax(num_tasks, weights):
    a, b = WeightedCalibration(num_tasks=num_tasks, device=CPU), WeightedCalibration(num_tasks=num_tasks, device=CPU)
    ja, jb = J.WeightedCalibration(num_tasks=num_tasks), J.WeightedCalibration(num_tasks=num_tasks)
    for i in range(6):
        clicks, probs, w = _batch(20 + i, num_tasks)
        wt = _weight(weights, w)
        (a if i % 2 else b).update(probs, clicks, wt)
        (ja if i % 2 else jb).update(probs, clicks, wt)
    a.merge_state([b])
    ja.merge_state([jb])
    _close(a.compute(), ja.compute())


def test_ctr_and_calibration_before_any_update_are_zero():
    for m, jm in ((ClickThroughRate(num_tasks=2, device=CPU), J.ClickThroughRate(num_tasks=2)),
                  (WeightedCalibration(num_tasks=2, device=CPU), J.WeightedCalibration(num_tasks=2))):
        _close(m.compute(), jm.compute())
        assert m.compute().tolist() == [0.0, 0.0]


@pytest.mark.parametrize("weighted", [False, True])
def test_collection_window_equals_standalone(weighted):
    col = MetricCollection({"cal": WeightedCalibration(num_tasks=3, device=CPU),
                            "wcal": WindowedWeightedCalibration(num_tasks=3, window_size=2, device=CPU)})
    alone = WeightedCalibration(num_tasks=3, device=CPU)
    jm = J.WeightedCalibration(num_tasks=3)
    for i in range(5):
        clicks, probs, w = _batch(30 + i, 3)
        args = (probs, clicks, w) if weighted else (probs, clicks)
        col.update(*[torch.from_numpy(a) for a in args])
        alone.update(*args)
        jm.update(*args)
    out = col.compute()
    _close(out["cal"], alone.compute())
    _close(out["cal"], jm.compute())
    _close(out["wcal"][0], jm.compute())


# ------------------------------------------------------------ the windows
def _windowed_pair(kind, **kw):
    if kind == "ctr":
        return WindowedClickThroughRate(device=CPU, **kw), J.WindowedClickThroughRate(**kw)
    return WindowedWeightedCalibration(device=CPU, **kw), J.WindowedWeightedCalibration(**kw)


def _feed(m, kind, seed, num_tasks, weights):
    clicks, probs, w = _batch(seed, num_tasks)
    wt = _weight(weights, w)
    if kind == "ctr":
        m.update(clicks, wt)
    else:
        m.update(probs, clicks, wt)


def _close_result(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


@pytest.mark.parametrize("weights", ["none", "array"])
@pytest.mark.parametrize("lifetime", [True, False])
@pytest.mark.parametrize("num_tasks", [1, 3])
@pytest.mark.parametrize("kind", ["ctr", "calibration"])
def test_windows_wrap_and_merge_like_jax(kind, num_tasks, lifetime, weights):
    kw = dict(num_tasks=num_tasks, window_size=3, enable_lifetime=lifetime)
    (a, ja), (b, jb) = _windowed_pair(kind, **kw), _windowed_pair(kind, **kw)
    for i in range(7):  # the window of 3 wraps twice
        _feed(a, kind, 40 + i, num_tasks, weights)
        _feed(ja, kind, 40 + i, num_tasks, weights)
    for i in range(2):
        _feed(b, kind, 50 + i, num_tasks, weights)
        _feed(jb, kind, 50 + i, num_tasks, weights)
    assert len(a.window) == len(ja.window) == 3
    _close_result(a.compute(), ja.compute())
    a.merge_state([b])
    ja.merge_state([jb])
    assert len(a.window) == len(ja.window) == 3
    for row, jrow in zip(a.window, ja.window):
        assert row.shape == (2, num_tasks)
        _close(row, np.asarray(jrow))
    _close_result(a.compute(), ja.compute())
    assert len(b.window) == 2  # the source is unchanged


@pytest.mark.parametrize("kind", ["ctr", "calibration"])
def test_empty_window_computes_zero_like_jax(kind):
    m, jm = _windowed_pair(kind, num_tasks=2, window_size=4)
    _close_result(m.compute(), jm.compute())


@pytest.mark.parametrize("attr", ["num_tasks", "window_size", "enable_lifetime"])
@pytest.mark.parametrize("kind", ["ctr", "calibration"])
def test_window_merge_needs_one_configuration(kind, attr):
    base = dict(num_tasks=2, window_size=3, enable_lifetime=True)
    other = dict(base, **{attr: {"num_tasks": 3, "window_size": 4, "enable_lifetime": False}[attr]})
    (a, ja), (b, jb) = _windowed_pair(kind, **base), _windowed_pair(kind, **other)
    _feed(a, kind, 60, 2, "none")
    before = [r.clone() for r in a.window]
    with pytest.raises(ValueError) as jax_err:
        ja.merge_state([jb])
    with pytest.raises(ValueError) as port_err:
        a.merge_state([b])
    assert str(port_err.value) == str(jax_err.value)
    assert len(a.window) == 1 and torch.equal(a.window[0], before[0])


@pytest.mark.parametrize(
    "make,jmake",
    [(lambda: WindowedClickThroughRate(window_size=0, device=CPU), lambda: J.WindowedClickThroughRate(window_size=0)),
     (lambda: WindowedWeightedCalibration(num_tasks=0, device=CPU), lambda: J.WindowedWeightedCalibration(num_tasks=0)),
     (lambda: ClickThroughRate(num_tasks=0, device=CPU), lambda: J.ClickThroughRate(num_tasks=0)),
     (lambda: WeightedCalibration(num_tasks=-1, device=CPU), lambda: J.WeightedCalibration(num_tasks=-1))],
    ids=["window_size", "windowed_tasks", "ctr_tasks", "calibration_tasks"],
)
def test_constructor_errors_match_jax(make, jmake):
    _raises_like_jax(make, jmake)


@pytest.mark.parametrize("kind", ["ctr", "calibration"])
def test_window_state_round_trips(kind):
    m, _ = _windowed_pair(kind, num_tasks=3, window_size=2)
    for i in range(3):
        _feed(m, kind, 70 + i, 3, "array")
    sd = m.state_dict()
    assert sd["window"].maxlen == 2 and len(sd["window"]) == 2
    fresh, _ = _windowed_pair(kind, num_tasks=3, window_size=2)
    fresh.load_state_dict(sd)
    _close_result(fresh.compute(), m.compute())
    copy = pickle.loads(pickle.dumps(m))
    assert copy.window.maxlen == 2
    _close_result(copy.compute(), m.compute())
    # the window configuration feeds the sync's schema digest
    assert m._sync_schema_extra == (3, 2, True)


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("kind", ["ctr", "calibration"])
def test_stacked_and_ragged_windows_fold_like_jax(kind, ragged):
    # same-shape batches fold stacked (under vmap), ragged ones batch by batch
    if kind == "ctr":
        m, jm = ClickThroughRate(num_tasks=3, device=CPU), J.ClickThroughRate(num_tasks=3)
    else:
        m, jm = WeightedCalibration(num_tasks=3, device=CPU), J.WeightedCalibration(num_tasks=3)
    for i in range(4):
        clicks, probs, w = _batch(80 + i, 3, n=40 + i if ragged else 53)
        args = (clicks, w) if kind == "ctr" else (probs, clicks, w)
        m.update(*args)
        jm.update(*args)
    got = m.compute()
    assert got.shape == (3,)
    _close(got, jm.compute())
