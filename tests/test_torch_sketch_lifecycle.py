"""Sketch state carried between the JAX package and the port, on the CPU.

Mirrors the mid-stream round trips of ``tests/sketch/test_sketch_lifecycle.py``
across the two packages through ``torcheval_tpu_torch/utils/jax_state.py``:
an ``approx=`` metric's ``state_dict`` (``sketch_tp``, ``sketch_fp``,
``sketch_nan_dropped``, and the staged rows not yet folded) taken in one
package and loaded into the other, where the stream continues. The counts
after the continuation must equal an uninterrupted stream's exactly, and
the values within atol 1e-8, rtol 1e-5. Covered: ``BinaryAUROC``,
``MulticlassAUPRC``, ``Quantile``, ``Cat`` and a sliced sketch member.
"""

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as JM
from torcheval_tpu_torch import metrics as TM
from torcheval_tpu_torch.utils.jax_state import (
    load_jax_state_dict,
    load_jax_state_dicts,
    numpy_state_dict,
    numpy_state_dicts,
)

RTOL, ATOL = 1e-5, 1e-8
CPU = "cpu"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_numpy_state(metric):
    out = {}
    for k, v in metric.state_dict().items():
        out[k] = [np.asarray(a) for a in v] if isinstance(v, list) else np.asarray(v)
    return out


def _binary_batches(k=6, n=700, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.lognormal(0, 3, n).astype(np.float32), (rng.random(n) < 0.4).astype(np.float32))
            for _ in range(k)]


def _mc_batches(k=4, n=500, c=5, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.random((n, c)).astype(np.float32), rng.integers(0, c, n)) for _ in range(k)]


CASES = {
    "BinaryAUROC": (lambda pkg, **kw: pkg.BinaryAUROC(approx=4096, compaction_threshold=1024, **kw),
                    _binary_batches),
    "MulticlassAUPRC": (lambda pkg, **kw: pkg.MulticlassAUPRC(
        num_classes=5, average=None, approx=True, compaction_threshold=900, **kw), _mc_batches),
    "Quantile": (lambda pkg, **kw: pkg.Quantile((0.1, 0.5, 0.9), **kw),
                 lambda: [(b[0],) for b in _binary_batches()]),
    "Cat": (lambda pkg, **kw: pkg.Cat(approx=1024, **kw),
            lambda: [(b[0],) for b in _binary_batches(seed=4)]),
}


def _settle(metric):
    """Fold staged rows into the resident sketch (``state_dict`` folds the
    deferred ``Quantile`` itself)."""
    # the port's score sketch, the JAX package's, then a value sketch
    for fold in ("_score_sketch_fold", "_compact", "_sketch_fold"):
        if hasattr(metric, fold):
            return getattr(metric, fold)()


def _results_equal(got, want):
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _results_equal(g, w)
        return
    np.testing.assert_allclose(_np(got).astype(np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_jax_to_port_mid_stream(name):
    make, batches = CASES[name]
    batches = batches()
    oracle = make(JM)
    for b in batches:
        oracle.update(*b)
    want = oracle.compute()
    head = make(JM)
    for b in batches[:3]:
        head.update(*b)
    state = _jax_numpy_state(head)
    port = make(TM, device=CPU)
    load_jax_state_dict(port, state)
    for b in batches[3:]:
        port.update(*b)
    _results_equal(port.compute(), want)
    _settle(port)
    _settle(oracle)
    ours, theirs = port.state_dict(), _jax_numpy_state(oracle)
    for key in ("sketch_tp", "sketch_fp", "sketch_counts", "bucket_counts"):
        if key in ours:
            np.testing.assert_array_equal(_np(ours[key]), theirs[key])


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_to_jax_mid_stream(name):
    make, batches = CASES[name]
    batches = batches()
    oracle = make(TM, device=CPU)
    for b in batches:
        oracle.update(*b)
    want = oracle.compute()
    head = make(TM, device=CPU)
    for b in batches[:3]:
        head.update(*b)
    state = numpy_state_dict(head)
    jax_metric = make(JM)
    jax_metric.load_state_dict(state)
    for b in batches[3:]:
        jax_metric.update(*b)
    got = jax_metric.compute()
    if isinstance(got, tuple):
        got = tuple(np.asarray(g) for g in got)
    _results_equal(want, got)


def test_staged_rows_travel_with_the_state():
    batches = _binary_batches()
    head = JM.BinaryAUROC(approx=4096, compaction_threshold=10_000)
    for b in batches[:2]:
        head.update(*b)
    state = _jax_numpy_state(head)
    assert len(state["inputs"]) == 2 and int(state["sketch_tp"].sum()) == 0
    port = TM.BinaryAUROC(approx=4096, compaction_threshold=10_000, device=CPU)
    load_jax_state_dict(port, state)
    assert port._sketch_staged == 1400
    assert float(port.compute()) == pytest.approx(float(head.compute()), rel=RTOL, abs=ATOL)


def test_sliced_sketch_member_state_both_ways():
    rng = np.random.default_rng(9)
    batches = [(rng.integers(0, 11, 300) * 13 - 5, rng.random(300).astype(np.float32),
                (rng.random(300) < 0.4).astype(np.float32)) for _ in range(4)]

    def make(pkg, **kw):
        return pkg.SlicedMetricCollection(
            {"acc": pkg.BinaryAccuracy(**kw), "auroc": pkg.BinaryAUROC(approx=1024, **kw)},
            capacity=4, curve_bucket_bits=6)

    oracle = make(JM)
    for b in batches:
        oracle.update(*b)
    want = oracle.compute()
    head = make(JM)
    for b in batches[:2]:
        head.update(*b)
    jstates = {m: {k: np.asarray(v) for k, v in sd.items()} for m, sd in head.state_dicts().items()}
    port = make(TM, device=CPU)
    load_jax_state_dicts(port, jstates)
    for b in batches[2:]:
        port.update(*b)
    got = port.compute()
    for member in ("acc", "auroc"):
        np.testing.assert_array_equal(got[member].slice_ids, np.asarray(want[member].slice_ids))
        np.testing.assert_allclose(_np(got[member]["values"]), np.asarray(want[member]["values"]),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(port.metrics["auroc"].state_dict()["sketch_tp"].numpy(),
                                  np.asarray(oracle.metrics["auroc"].state_dict()["sketch_tp"]))
    back = make(JM)
    back.load_state_dicts(numpy_state_dicts(port))
    np.testing.assert_allclose(np.asarray(back.compute()["auroc"]["values"]),
                               np.asarray(want["auroc"]["values"]), rtol=RTOL, atol=ATOL)
