"""The port's half-precision and other non-float32 inputs against the JAX
package's, on the CPU.

Each case is an input on which the port once failed against the JAX
package: the compacting curve metrics on bfloat16, float16, float64 and
int32 scores; sliced ``Sum``/``Mean`` on bfloat16 and float16 values; the
functional ``sum``/``mean`` on half-precision input; the type of ``Max``
and ``Min`` on half-precision input; and the exports of the sliced
collection's result types. The same numpy inputs, made from a seed, go
through both packages (``device="cpu"`` on the port's metrics). Values are
compared within rtol 1e-5 and atol 1e-8 unless a case says exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.metrics.functional as JF
import torcheval_tpu_torch.metrics as T
from torcheval_tpu_torch.metrics.functional import mean as tmean
from torcheval_tpu_torch.metrics.functional import sum as tsum

RTOL, ATOL = 1e-5, 1e-8
CPU = "cpu"
TYPES = {
    "bfloat16": (torch.bfloat16, jnp.bfloat16),
    "float16": (torch.float16, jnp.float16),
    "float64": (torch.float64, jnp.float64),
    "int32": (torch.int32, jnp.int32),
}


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64), rtol=RTOL, atol=ATOL
    )


def _curve_batches():
    """3 batches of 300 scores uniform in [0, 1) with 0/1 targets."""
    rng = np.random.default_rng(5)
    scores = rng.random((3, 300)).astype(np.float32)
    targets = rng.integers(0, 2, (3, 300)).astype(np.float32)
    return list(zip(scores, targets))


@pytest.mark.parametrize("threshold", [100, None], ids=["compacting", "raw"])
@pytest.mark.parametrize("kind", list(TYPES))
@pytest.mark.parametrize("name", ["BinaryAUROC", "BinaryAUPRC"])
def test_curve_metrics_fold_every_score_type_like_jax(name, kind, threshold):
    tdt, jdt = TYPES[kind]
    port = getattr(T, name)(compaction_threshold=threshold, device=CPU)
    ref = getattr(J, name)(compaction_threshold=threshold)
    for s, t in _curve_batches():
        if kind == "int32":
            s = np.floor(s * 50)
        port.update(torch.tensor(s).to(tdt), torch.tensor(t))
        ref.update(jnp.asarray(s).astype(jdt), jnp.asarray(t))
    _close(port.compute(), ref.compute())


def test_bf16_compacting_curves_give_the_reference_values():
    auroc = T.BinaryAUROC(compaction_threshold=100, device=CPU)
    auprc = T.BinaryAUPRC(compaction_threshold=100, device=CPU)
    for s, t in _curve_batches():
        auroc.update(torch.tensor(s).bfloat16(), torch.tensor(t))
        auprc.update(torch.tensor(s).bfloat16(), torch.tensor(t))
    assert float(auroc.compute()) == pytest.approx(0.48699, abs=5e-6)
    assert float(auprc.compute()) == pytest.approx(0.51331, abs=5e-6)


def _sliced_batches():
    """4 updates of 50 values over 5 cohort ids."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 5, 50), rng.standard_normal(50).astype(np.float32)) for _ in range(4)]


@pytest.mark.parametrize("kind", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", ["Sum", "Mean"])
def test_sliced_sum_and_mean_on_half_precision_like_jax(name, kind):
    """Exactly equal: both packages add a batch's half-precision deltas in
    their own type, in sample order, then into the float32 state. The JAX
    collection defers batches and folds a window at once, so its
    ``compute()`` runs after each update to fold each batch alone, as the
    port does."""
    tdt, jdt = TYPES[kind]
    port = T.SlicedMetricCollection({"m": getattr(T, name)(device=CPU)})
    ref = J.SlicedMetricCollection({"m": getattr(J, name)()})
    for ids, v in _sliced_batches():
        port.update(ids, torch.tensor(v).to(tdt))
        ref.update(ids, jnp.asarray(v).astype(jdt))
        want = ref.compute()["m"]
    got = port.compute()["m"]
    np.testing.assert_array_equal(got["slice_ids"], np.asarray(want["slice_ids"]))
    np.testing.assert_array_equal(got["values"].numpy(), np.asarray(want["values"]))


U_HALF = {"bfloat16": 2.0**-8, "float16": 2.0**-11}


@pytest.mark.parametrize("kind", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", ["Sum", "Mean"])
def test_sliced_half_precision_gap_to_jax_default_window_schedule(name, kind):
    """The JAX collection in its default use: every update deferred, one
    window of all four batches' half-precision deltas folded at the end.
    The port folds each batch as it comes, so the two add in different
    orders and differ (on this input by 0.0586 (bfloat16) and 0.00977
    (float16) in a cohort's Sum, 0.00146 and 0.000244 in its Mean). Both
    stay within the half type's summation bound of the exact per-cohort
    value, ``count * u * sum|v|`` (``(count - 1) * u * sum|v|`` for the adds
    and ``u * |sum|`` for the final rounding; over ``count`` for the Mean,
    plus its division's rounding), so the gap is at most twice that."""
    tdt, jdt = TYPES[kind]
    port = T.SlicedMetricCollection({"m": getattr(T, name)(device=CPU)})
    ref = J.SlicedMetricCollection({"m": getattr(J, name)()})
    batches = _sliced_batches()
    for ids, v in batches:
        port.update(ids, torch.tensor(v).to(tdt))
        ref.update(ids, jnp.asarray(v).astype(jdt))
    got, want = port.compute()["m"], ref.compute()["m"]
    np.testing.assert_array_equal(got["slice_ids"], np.asarray(want["slice_ids"]))
    ids = np.concatenate([i for i, _ in batches])
    vals = np.concatenate([np.asarray(jnp.asarray(v).astype(jdt), np.float64) for _, v in batches])
    cohorts = np.asarray(got["slice_ids"])
    count = np.array([(ids == c).sum() for c in cohorts], np.float64)
    exact = np.array([vals[ids == c].sum() for c in cohorts])
    mag = np.array([np.abs(vals[ids == c]).sum() for c in cohorts])
    u = U_HALF[kind]
    bound = count * u * mag
    if name == "Mean":
        exact, bound = exact / count, bound / count + u * np.abs(exact / count)
    port_v = got["values"].double().numpy()
    jax_v = np.asarray(want["values"], np.float64)
    assert (np.abs(port_v - exact) <= bound).all()
    assert (np.abs(jax_v - exact) <= bound).all()
    assert (np.abs(port_v - jax_v) <= 2 * bound).all()


@pytest.mark.parametrize("kind", ["bfloat16", "float16"])
def test_functional_sum_and_mean_on_half_precision_like_jax(kind):
    tdt, jdt = TYPES[kind]
    x = np.random.default_rng(3).standard_normal(8000).astype(np.float32)
    got_sum, got_mean = tsum(torch.tensor(x).to(tdt)), tmean(torch.tensor(x).to(tdt))
    assert got_sum.dtype == got_mean.dtype == torch.float32
    _close(got_sum, JF.sum(jnp.asarray(x).astype(jdt)))
    _close(got_mean, JF.mean(jnp.asarray(x).astype(jdt)))
    if kind == "bfloat16":
        exact = float(np.asarray(jnp.asarray(x).astype(jdt), np.float64).sum())
        _close(got_sum, exact)
        assert float(got_sum) == pytest.approx(25.3352, abs=5e-5)


@pytest.mark.parametrize("kind", ["bfloat16", "float16"])
def test_one_batch_sum_class_stays_half_precision_like_jax(kind):
    tdt, jdt = TYPES[kind]
    x = np.random.default_rng(3).standard_normal(8000).astype(np.float32)
    port = T.Sum(device=CPU).update(torch.tensor(x).to(tdt))
    ref = J.Sum().update(jnp.asarray(x).astype(jdt))
    np.testing.assert_array_equal(port.compute().numpy(), np.asarray(ref.compute()))


@pytest.mark.parametrize("kind", ["bfloat16", "float16", "float64", "int32"])
@pytest.mark.parametrize("name", ["Max", "Min"])
def test_max_and_min_keep_the_inputs_type_like_jax(name, kind):
    tdt, jdt = TYPES[kind]
    rng = np.random.default_rng(1)
    chunks = [rng.standard_normal(64).astype(np.float32) * 100 for _ in range(3)]
    port, ref = getattr(T, name)(device=CPU), getattr(J, name)()
    for c in chunks:
        port.update(torch.tensor(c).to(tdt))
        ref.update(jnp.asarray(c).astype(jdt))
    got, want = port.compute(), ref.compute()
    assert str(got.dtype)[6:] == str(np.asarray(want).dtype) or kind in ("float64", "int32")
    np.testing.assert_array_equal(got.double().numpy(), np.asarray(want, np.float64))
    # a fresh replica merged in changes neither the value nor the type
    merged = port.merge_state([getattr(T, name)(device=CPU)])
    assert merged.compute().dtype == got.dtype
    fresh = getattr(T, name)(device=CPU).merge_state([port])
    assert fresh.compute().dtype == got.dtype
    assert port.reset().compute().dtype == torch.float32


def test_sliced_result_types_are_exported_like_jax():
    from torcheval_tpu_torch.metrics.sliced import SlicedResult, SliceTable

    assert T.SliceTable is SliceTable and T.SlicedResult is SlicedResult
    assert {"SliceTable", "SlicedResult"} <= set(T.__all__) & set(J.__all__)
