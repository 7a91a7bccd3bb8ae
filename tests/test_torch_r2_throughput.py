"""The port's ``R2Score`` (functional and class), ``Throughput`` and
``utils/tracing.py`` against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through ``torcheval_tpu`` and
``torcheval_tpu_torch`` (``device="cpu"``). Values within atol 1e-8 / rtol
1e-5 (both accumulate in float32, in different orders), the int32 counts
exactly, the JAX package's error messages exactly. Warnings are logged on
a daemon thread, so the tests that read them first wait with
``tracing.join_pending``.
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu_torch.metrics import MetricCollection, R2Score, Throughput
from torcheval_tpu_torch.metrics.functional import r2_score
from torcheval_tpu_torch.utils import tracing

RTOL, ATOL = 1e-5, 1e-8
CPU = "cpu"
MODES = ["uniform_average", "raw_values", "variance_weighted"]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


def _batch(seed, n=83, outputs=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if outputs is None else (n, outputs)
    y = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    yhat = (y + rng.standard_normal(shape) * 0.7).astype(np.float32)
    return yhat, y


# ------------------------------------------------------------------- R2Score
@pytest.mark.parametrize("num_regressors", [0, 3])
@pytest.mark.parametrize("multioutput", MODES)
@pytest.mark.parametrize("outputs", [None, 4])
def test_functional_r2_matches_jax(outputs, multioutput, num_regressors):
    yhat, y = _batch(1, outputs=outputs)
    kw = dict(multioutput=multioutput, num_regressors=num_regressors)
    _close(r2_score(yhat, y, **kw), JF.r2_score(yhat, y, **kw))


@pytest.mark.parametrize("num_regressors", [0, 2])
@pytest.mark.parametrize("multioutput", MODES)
@pytest.mark.parametrize("outputs", [None, 3])
def test_class_r2_streams_and_merges_like_jax(outputs, multioutput, num_regressors):
    kw = dict(multioutput=multioutput, num_regressors=num_regressors)
    a, b = R2Score(device=CPU, **kw), R2Score(device=CPU, **kw)
    ja, jb = J.R2Score(**kw), J.R2Score(**kw)
    for i in range(6):
        yhat, y = _batch(10 + i, n=50 + 3 * (i % 2), outputs=outputs)
        (a if i % 2 else b).update(yhat, y)
        (ja if i % 2 else jb).update(yhat, y)
    _close(b.compute(), jb.compute())
    a.merge_state([b])
    ja.merge_state([jb])
    _close(a.compute(), ja.compute())
    sd, jsd = a.state_dict(), ja.state_dict()
    assert sd["num_obs"].dtype == torch.int32
    assert int(sd["num_obs"]) == int(np.asarray(jsd["num_obs"])) == 6 * 50 + 9
    for name in ("sum_squared_obs", "sum_obs", "sum_squared_residual"):
        _close(sd[name], np.asarray(jsd[name]))


def test_r2_in_a_collection_folds_one_window_like_jax():
    col = MetricCollection({"r2": R2Score(multioutput="raw_values", device=CPU)})
    jm = J.R2Score(multioutput="raw_values")
    for i in range(5):
        yhat, y = _batch(20 + i, outputs=2)
        col.update(torch.from_numpy(yhat), torch.from_numpy(y))
        jm.update(yhat, y)
    _close(col.compute()["r2"], jm.compute())


def _raises_like_jax(port_call, jax_call):
    with pytest.raises(ValueError) as jax_err:
        jax_call()
    with pytest.raises(ValueError) as port_err:
        port_call()
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("case", ["one_sample", "too_many_regressors", "rank_3", "shapes"])
def test_r2_errors_match_jax(case):
    yhat, y = _batch(30, n=6)
    args, kw = {
        "one_sample": ((yhat[:1], y[:1]), {}),
        "too_many_regressors": ((yhat, y), {"num_regressors": 5}),
        "rank_3": ((yhat.reshape(1, 2, 3), y.reshape(1, 2, 3)), {}),
        "shapes": ((yhat, y[:5]), {}),
    }[case]
    _raises_like_jax(lambda: r2_score(*args, **kw), lambda: JF.r2_score(*args, **kw))
    _raises_like_jax(lambda: R2Score(device=CPU, **kw).update(*args).compute(),
                     lambda: J.R2Score(**kw).update(*args).compute())


@pytest.mark.parametrize("kw", [{"multioutput": "median"}, {"num_regressors": -1},
                                {"num_regressors": 1.5}], ids=["multioutput", "negative", "float"])
def test_r2_parameter_errors_match_jax(kw):
    _raises_like_jax(lambda: R2Score(device=CPU, **kw), lambda: J.R2Score(**kw))


# ---------------------------------------------------------------- Throughput
def test_throughput_matches_jax_and_merges_by_the_slowest():
    a, b, ja, jb = Throughput(device=CPU), Throughput(device=CPU), J.Throughput(), J.Throughput()
    for m in (a, ja):
        m.update(1000, 2.0).update(500, 1.0)
    for m in (b, jb):
        m.update(3000, 4.5)
    _close(a.compute(), ja.compute())
    a.merge_state([b])
    ja.merge_state([jb])
    _close(a.compute(), ja.compute())
    assert float(a.elapsed_time_sec) == 4.5 and float(a.num_total) == 4500.0
    _close(a.compute(), 4500 / 4.5)


@pytest.mark.parametrize("args", [(-1, 1.0), (10, 0.0), (10, -2.0)], ids=["count", "zero", "negative"])
def test_throughput_errors_match_jax(args):
    _raises_like_jax(lambda: Throughput(device=CPU).update(*args), lambda: J.Throughput().update(*args))


def test_throughput_without_update_warns_and_is_zero(caplog):
    with caplog.at_level(logging.WARNING):
        got = Throughput(device=CPU).compute()
        assert tracing.join_pending(timeout=30)
    assert float(got) == 0.0 == float(J.Throughput().compute())
    assert any("No calls to update()" in r.message for r in caplog.records)


def test_throughput_state_round_trips():
    m = Throughput(device=CPU).update(10, 0.5)
    fresh = Throughput(device=CPU)
    fresh.load_state_dict(m.state_dict())
    _close(fresh.compute(), 20.0)


# ------------------------------------------------------------------ tracing
@pytest.mark.parametrize(
    "value,want",
    [(np.zeros(3), True), (torch.zeros(3), True), (1.5, True), (7, True),
     (torch.zeros(3, device="meta"), False), ([1.0, 2.0], False)],
    ids=["numpy", "cpu_tensor", "float", "int", "off_host_tensor", "list"],
)
def test_host_resident(value, want):
    assert tracing.host_resident(value) is want


def test_async_value_warn_never_blocks_the_caller():
    release, seen = threading.Event(), []

    def check(x):
        release.wait(30)
        seen.append(x.tolist())

    t0 = time.perf_counter()
    t = tracing.async_value_warn(check, torch.tensor([1, 2]))
    assert time.perf_counter() - t0 < 5 and t.is_alive() and not seen
    release.set()
    assert tracing.join_pending(timeout=30) and not t.is_alive()
    assert seen == [[1, 2]]


def test_async_value_warn_reads_a_snapshot_and_survives_a_failing_check():
    x = torch.tensor([0.0, 3.0])
    got = []
    tracing.async_value_warn(lambda v, n: got.append((v.tolist(), int(n))), x, 4)
    x.add_(1.0)  # written after the call: the check sees the values at the call
    tracing.async_value_warn(lambda v: 1 / 0, x)
    assert tracing.join_pending(timeout=30)
    assert got == [([0.0, 3.0], 4)]


def test_async_value_warn_skips_under_a_transform():
    calls = []
    torch.func.vmap(lambda x: (tracing.async_value_warn(calls.append, x), x)[1])(torch.ones(3, 2))
    assert tracing.join_pending(timeout=30) and calls == []
