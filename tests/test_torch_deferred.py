"""The port's deferred folds (``metrics/deferred.py``) against the JAX
package's, on the CPU.

The cases mirror ``tests/metrics/test_deferred.py`` and
``tests/obs/test_fold_dispatch_count.py``: group folds of standalone
metrics, the byte and chunk valve (and its exact 2x for a collection's
member streamed into directly), signature and type flushes, merges with
pending batches on both sides, pickling and deepcopy mid-stream,
``load_state_dict`` mid-window and partial, reset, stacked against ragged
folds (an exact member's ragged window folded once, a float member's a
batch at a time, and the exact trait held to integer folds), and the
number of window steps per budget window. The same numpy
inputs, made from a seed, go through both packages (``device="cpu"`` on the
port's metrics). Integer states must match exactly and floats within rtol
1e-5; the valve cadence of the port (``deferred.window_steps`` and
``deferred.folds`` in its obs registry) must equal the JAX package's, read
from its obs counters. The in-place-mutation guard and the eager fold under
``torch.func`` have no JAX counterpart.
"""

import copy
import pickle
from contextlib import contextmanager

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu_torch.metrics as T
from torcheval_tpu import obs as jobs
from torcheval_tpu_torch.utils.test_utils.obs_counts import count, recording

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-8


def _batch(rng, n=32, c=4):
    return rng.random((n, c)).astype(np.float32), rng.integers(0, c, n)


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=RTOL, atol=ATOL
    )


def _equal_states(port_metric, jax_metric):
    got, want = port_metric.state_dict(), jax_metric.state_dict()
    assert set(got) == set(want)
    for name in got:
        g, w = got[name].numpy(), np.asarray(want[name])
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, w)


@pytest.fixture(autouse=True)
def _obs_on():
    """The port's fold counters live in its obs registry: on for every case."""
    with recording():
        yield


class _Counts:
    """Deltas of the port's fold counters since construction."""

    def __init__(self):
        self.start = self._now()

    @staticmethod
    def _now():
        return (
            count("deferred.window_steps"),
            count("deferred.window_step_batches"),
            count("deferred.folds"),
            count("deferred.folds", entry="group_fold"),
        )

    def __call__(self):
        keys = ("window_steps", "window_step_batches", "folds", "grouped")
        return dict(zip(keys, (a - b for a, b in zip(self._now(), self.start))))


@contextmanager
def _jax_counts():
    """The JAX package's fold counters: window steps, batches and folds."""
    jobs.reset()
    jobs.enable()

    def read():
        counters = jobs.snapshot()["counters"]

        def total(prefix):
            return int(sum(v for k, v in counters.items() if k.startswith(prefix)))

        return {
            "window_steps": total("deferred.window_steps"),
            "window_step_batches": total("deferred.window_step_batches"),
            "folds": total("deferred.folds"),
        }

    try:
        yield read
    finally:
        jobs.disable()
        jobs.reset()


# ------------------------------------------------------------- group folds
def test_same_batches_fold_in_one_group():
    rng = np.random.default_rng(42)
    x, t = _batch(rng, 64)
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    acc = T.MulticlassAccuracy(num_classes=4, device=CPU)
    f1 = T.MulticlassF1Score(num_classes=4, average="macro", device=CPU)
    jacc = J.MulticlassAccuracy(num_classes=4)
    jf1 = J.MulticlassF1Score(num_classes=4, average="macro")
    jx, jt = jnp.asarray(x), jnp.asarray(t)
    for _ in range(3):
        acc.update(tx, tt)
        f1.update(tx, tt)
        jacc.update(jx, jt)
        jf1.update(jx, jt)
    assert acc._pending and f1._pending
    counts = _Counts()
    got_acc = acc.compute()  # folds both metrics
    assert f1._pending == []
    got_f1 = f1.compute()
    assert counts() == {"window_steps": 0, "window_step_batches": 0, "folds": 1, "grouped": 1}
    _close(got_acc, jacc.compute())
    _close(got_f1, jf1.compute())
    _equal_states(f1, jf1)


def test_valve_triggered_fold_groups_common_prefix():
    rng = np.random.default_rng(7)
    a = T.MulticlassAccuracy(num_classes=4, device=CPU)
    b = T.MulticlassF1Score(num_classes=4, average="macro", device=CPU)
    ja = J.MulticlassAccuracy(num_classes=4)
    jb = J.MulticlassF1Score(num_classes=4, average="macro")
    for m in (a, b, ja, jb):
        m._DEFER_MAX_CHUNKS = 4
    batches = [_batch(rng, 16) for _ in range(6)]
    counts = _Counts()
    with _jax_counts() as jax_read:
        for x, t in batches:
            tx, tt = torch.from_numpy(x), torch.from_numpy(t)
            a.update(tx, tt)  # the valve fires here at batch 4, b holds 3
            b.update(tx, tt)
            jx, jt = jnp.asarray(x), jnp.asarray(t)
            ja.update(jx, jt)
            jb.update(jx, jt)
        got_a, got_b = a.compute(), b.compute()
        want_a, want_b = ja.compute(), jb.compute()
        jax_folds = jax_read()["folds"]
    c = counts()
    assert c["folds"] == c["grouped"] >= 2  # every fold was a group fold
    assert c["folds"] == jax_folds
    _close(got_a, want_a)
    _close(got_b, want_b)
    _equal_states(b, jb)


def test_pickle_restored_metric_rejoins_grouping():
    rng = np.random.default_rng(3)
    m1 = T.MulticlassAccuracy(num_classes=4, device=CPU)
    m2 = pickle.loads(pickle.dumps(m1))
    m3 = T.MulticlassAccuracy(num_classes=4, device=CPU)
    x, t = _batch(rng)
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    m2.update(tx, tt)
    m3.update(tx, tt)
    counts = _Counts()
    m3.compute()
    assert counts()["grouped"] == 1
    assert m2._pending == []  # the restored metric was grouped
    _close(m2.compute(), J.MulticlassAccuracy(num_classes=4).update(x, t).compute())


def test_different_batches_do_not_group():
    rng = np.random.default_rng(5)
    (xa, ta), (xb, tb) = _batch(rng), _batch(rng)
    a = T.MulticlassAccuracy(num_classes=4, device=CPU).update(xa, ta)
    b = T.MulticlassAccuracy(num_classes=4, device=CPU).update(xb, tb)
    counts = _Counts()
    a.compute()
    assert counts()["grouped"] == 0
    assert b._pending  # untouched
    _close(b.compute(), J.MulticlassAccuracy(num_classes=4).update(xb, tb).compute())


# ------------------------------------------------------------------- edges
def test_merge_with_pending_on_both_sides():
    rng = np.random.default_rng(11)
    (xa, ta), (xb, tb) = _batch(rng), _batch(rng)
    a = T.MulticlassAccuracy(average="macro", num_classes=4, device=CPU).update(xa, ta)
    b = T.MulticlassAccuracy(average="macro", num_classes=4, device=CPU).update(xb, tb)
    ja = J.MulticlassAccuracy(average="macro", num_classes=4).update(xa, ta)
    jb = J.MulticlassAccuracy(average="macro", num_classes=4).update(xb, tb)
    assert a._pending and b._pending and ja._pending and jb._pending
    a.merge_state([b])
    ja.merge_state([jb])
    _equal_states(a, ja)
    _close(a.compute(), ja.compute())
    _equal_states(b, jb)  # the source is unchanged


def test_signature_change_flushes_pending():
    rng = np.random.default_rng(13)
    t1 = rng.integers(0, 4, 16)
    x2, t2 = _batch(rng, 24)
    m = T.MulticlassAccuracy(num_classes=4, device=CPU)
    jm = J.MulticlassAccuracy(num_classes=4)
    for metric in (m, jm):
        metric.update(t1.astype(np.float32), t1)  # 1-D input
        metric.update(x2, t2)  # 2-D: flush, then append
    assert len(m._pending) == len(jm._pending) == 1
    _equal_states(m, jm)
    _close(m.compute(), (16 + int((x2.argmax(1) == t2).sum())) / 40.0)


def test_dtype_change_flushes_pending():
    rng = np.random.default_rng(17)
    x1, x2 = rng.random(16).astype(np.float32), rng.random(16).astype(np.float32)
    t1 = rng.integers(0, 2, 16).astype(np.float32)
    t2 = rng.integers(0, 2, 16).astype(np.int32)  # the target's type changes
    m, jm = T.BinaryAccuracy(device=CPU), J.BinaryAccuracy()
    m.update(x1, t1)
    jm.update(x1, t1)
    m.update(x2, t2)
    jm.update(x2, t2)
    assert len(m._pending) == 1 and m.state_dict()["num_total"] == 32
    _equal_states(m, jm)
    _close(m.compute(), jm.compute())


def test_pickle_and_deepcopy_mid_stream():
    rng = np.random.default_rng(19)
    x, t = _batch(rng, 48)
    m = T.MulticlassF1Score(num_classes=4, average="macro", device=CPU).update(x, t)
    assert m._pending
    clones = [pickle.loads(pickle.dumps(m)), copy.deepcopy(m)]
    assert m._pending == []  # both folded the original first
    x2, t2 = _batch(rng, 16)
    ref = J.MulticlassF1Score(num_classes=4, average="macro").update(x, t).update(x2, t2)
    for clone in clones:
        assert clone._pending == [] and not hasattr(clone, "_defer_windows")
        _close(clone.compute(), m.compute())
        clone.update(x2, t2)  # keeps streaming
        _equal_states(clone, ref)
        _close(clone.compute(), ref.compute())


def test_byte_budget_valve():
    rng = np.random.default_rng(23)
    x, t = _batch(rng, 256)
    m = T.MulticlassAccuracy(num_classes=4, device=CPU)
    jm = J.MulticlassAccuracy(num_classes=4)
    m._DEFER_BUDGET_BYTES = 3 * (x.nbytes + t.nbytes)
    jm._DEFER_BUDGET_BYTES = 3 * (x.nbytes + jnp.asarray(t).nbytes)
    counts = _Counts()
    with _jax_counts() as jax_read:
        for _ in range(10):
            m.update(x, t)
            jm.update(x, t)
        assert len(m._pending) == len(jm._pending) < 4  # the valve fired
        assert counts()["folds"] == jax_read()["folds"] == 3
    assert m.state_dict()["num_total"] == 2560
    _equal_states(m, jm)


def test_load_state_dict_mid_window_restore_is_exact():
    rng = np.random.default_rng(29)
    x, t = _batch(rng)
    sd = T.MulticlassAccuracy(num_classes=4, device=CPU).update(x, t).state_dict()
    m = T.MulticlassAccuracy(num_classes=4, device=CPU).update(x[:8], t[:8])
    jm = J.MulticlassAccuracy(num_classes=4).update(x[:8], t[:8])
    assert m._pending
    m.load_state_dict(sd)
    jm.load_state_dict(J.MulticlassAccuracy(num_classes=4).update(x, t).state_dict())
    assert m._pending == []
    assert int(m.num_total) == x.shape[0]
    _equal_states(m, jm)


def test_partial_load_keeps_pending_contribution_in_untouched_states():
    rng = np.random.default_rng(31)
    x, t = _batch(rng, 24)
    m = T.MulticlassAccuracy(num_classes=4, device=CPU).update(x, t)
    jm = J.MulticlassAccuracy(num_classes=4).update(x, t)
    m.load_state_dict({"num_correct": torch.zeros((), dtype=torch.int32)}, strict=False)
    jm.load_state_dict({"num_correct": jnp.zeros((), jnp.int32)}, strict=False)
    assert int(m.state_dict()["num_total"]) == 24
    assert int(m.state_dict()["num_correct"]) == 0
    _equal_states(m, jm)


def test_reset_discards_pending():
    rng = np.random.default_rng(37)
    x, t = _batch(rng)
    m = T.MulticlassAccuracy(num_classes=4, device=CPU).update(x, t)
    assert m._pending and m._pending_bytes > 0 and m._pending_sig is not None
    m.reset()
    assert m._pending == [] and m._pending_bytes == 0 and m._pending_sig is None
    x2, t2 = _batch(rng, 16)
    m.update(x2, t2)
    jm = J.MulticlassAccuracy(num_classes=4).update(x, t).reset().update(x2, t2)
    assert int(m.state_dict()["num_total"]) == 16
    _equal_states(m, jm)


# ------------------------------------------------------------------ valves
def test_managed_member_direct_stream_valve_fires_at_exactly_2x():
    rng = np.random.default_rng(41)
    m = T.MulticlassAccuracy(num_classes=4, device=CPU)
    jm = J.MulticlassAccuracy(num_classes=4)
    T.MetricCollection(m)  # marks m managed: the collection owns the trigger
    J.MetricCollection(jm)
    m._DEFER_MAX_CHUNKS = jm._DEFER_MAX_CHUNKS = 3
    x, t = _batch(rng, 8)
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    for i in range(1, 6):  # 2 * 3: the 1x cap at batch 3 does not fold
        m.update(tx, tt)
        jm.update(x, t)
        assert len(m._pending) == len(jm._pending) == i
    m.update(tx, tt)
    jm.update(x, t)
    assert m._pending == [] and jm._pending == []
    assert int(m.num_total) == 48  # folded, not dropped
    _equal_states(m, jm)


def test_mixed_signature_flush_folds_old_before_append():
    rng = np.random.default_rng(43)
    t1 = rng.integers(0, 4, 16)
    m = T.MulticlassAccuracy(num_classes=4, device=CPU)
    x1, tt1 = torch.from_numpy(t1.astype(np.float32)), torch.from_numpy(t1)
    m.update(x1, tt1)
    m.update(x1, tt1)
    assert len(m._pending) == 2
    x2, t2 = _batch(rng, 24)
    m.update(x2, t2)
    assert len(m._pending) == 1 and m._pending[0][0].ndim == 2
    assert int(m.num_total) == 32  # the old batches are in the state
    jm = J.MulticlassAccuracy(num_classes=4)
    for xs, ts in ((t1.astype(np.float32), t1), (t1.astype(np.float32), t1), (x2, t2)):
        jm.update(xs, ts)
    _equal_states(m, jm)


# -------------------------------------------------- stacked against ragged
def test_uniform_vs_ragged_chunks_agree():
    rng = np.random.default_rng(47)
    x, t = _batch(rng, 60)
    uniform = T.MulticlassAccuracy(average="macro", num_classes=4, device=CPU)
    ragged = T.MulticlassAccuracy(average="macro", num_classes=4, device=CPU)
    for i in range(4):  # four (15, 4) batches: the stacked fold
        uniform.update(x[i * 15:(i + 1) * 15], t[i * 15:(i + 1) * 15])
    ragged.update(x[:20], t[:20])  # (20, 4) then (40, 4): the ragged fold
    ragged.update(x[20:], t[20:])
    want = J.MulticlassAccuracy(average="macro", num_classes=4).update(x, t)
    _equal_states(uniform, want)
    _equal_states(ragged, want)


def _count_fold_fn(monkeypatch, cls):
    """A list that grows by one at each call of ``cls._fold_fn`` (a vmapped
    call is one)."""
    calls, fn = [], cls._fold_fn

    def counting(*args):
        calls.append(1)
        return fn(*args)

    monkeypatch.setattr(cls, "_fold_fn", staticmethod(counting))
    return calls


def _multiclass(rng, n, c=8):
    return rng.random((n, c)).astype(np.float32), rng.integers(0, c, n)


def _labels(rng, n, c=8):
    return rng.integers(0, c, n), rng.integers(0, c, n)


def _binary(rng, n):
    return rng.random(n).astype(np.float32), rng.integers(0, 2, n)


def _multilabel(rng, n, c=6):
    return rng.random((n, c)).astype(np.float32), rng.integers(0, 2, (n, c))


# (port metric, JAX metric, batch maker): every exact member, each input form
_EXACT = {
    "micro": (lambda: T.MulticlassAccuracy(device=CPU), J.MulticlassAccuracy, _multiclass),
    "macro": (
        lambda: T.MulticlassAccuracy(average="macro", num_classes=8, device=CPU),
        lambda: J.MulticlassAccuracy(average="macro", num_classes=8),
        _multiclass,
    ),
    "micro-labels": (lambda: T.MulticlassAccuracy(device=CPU), J.MulticlassAccuracy, _labels),
    "macro-labels": (
        lambda: T.MulticlassAccuracy(average="macro", num_classes=8, device=CPU),
        lambda: J.MulticlassAccuracy(average="macro", num_classes=8),
        _labels,
    ),
    "top5": (lambda: T.MulticlassAccuracy(k=5, device=CPU), lambda: J.MulticlassAccuracy(k=5), _multiclass),
    "none": (
        lambda: T.MulticlassAccuracy(average=None, num_classes=8, device=CPU),
        lambda: J.MulticlassAccuracy(average=None, num_classes=8),
        _multiclass,
    ),
    "binary": (lambda: T.BinaryAccuracy(device=CPU), J.BinaryAccuracy, _binary),
    "multilabel-exact_match": (
        lambda: T.MultilabelAccuracy(device=CPU), J.MultilabelAccuracy, _multilabel
    ),
    "multilabel-hamming": (
        lambda: T.MultilabelAccuracy(criteria="hamming", device=CPU),
        lambda: J.MultilabelAccuracy(criteria="hamming"),
        _multilabel,
    ),
    "topk": (
        lambda: T.TopKMultilabelAccuracy(k=2, criteria="overlap", device=CPU),
        lambda: J.TopKMultilabelAccuracy(k=2, criteria="overlap"),
        _multilabel,
    ),
}


@pytest.mark.parametrize("case", list(_EXACT))
def test_ragged_exact_member_folds_its_concatenation_once(monkeypatch, case):
    """Three equal batches and a short tail: an exact member folds the
    window's concatenated rows in one ``_fold_fn`` call, and its integer
    states equal the JAX package's, which folds a batch at a time."""
    make_port, make_jax, make_batch = _EXACT[case]
    m, jm = make_port(), make_jax()
    calls = _count_fold_fn(monkeypatch, type(m))
    rng = np.random.default_rng(101)
    for n in (24, 24, 24, 7):
        batch = make_batch(rng, n)
        m.update(*batch)
        jm.update(*batch)
    before = count("deferred.fold_calls", shape="ragged")
    _equal_states(m, jm)
    assert len(calls) == 1
    assert count("deferred.fold_calls", shape="ragged") == before
    _close(m.compute(), jm.compute())


def test_a_float_member_beside_an_exact_one_keeps_the_ragged_shape(monkeypatch):
    """In one ragged window, the float sum folds a batch at a time, as the
    JAX package does, and the exact member folds the concatenation once."""
    col = T.MetricCollection({"acc": T.BinaryAccuracy(device=CPU), "mse": T.MeanSquaredError(device=CPU)})
    acc_calls = _count_fold_fn(monkeypatch, T.BinaryAccuracy)
    mse_calls = _count_fold_fn(monkeypatch, T.MeanSquaredError)
    jacc, jmse = J.BinaryAccuracy(), J.MeanSquaredError()
    rng = np.random.default_rng(103)
    for n in (24, 24, 24, 7):
        x, t = rng.random(n).astype(np.float32), rng.integers(0, 2, n).astype(np.float32)
        col.update(x, t)
        jacc.update(x, t)
        jmse.update(x, t)
    before = count("deferred.fold_calls", shape="ragged")
    col.compute()
    # the first batch runs through each member's own update (validation)
    # and is moved into the window: every batch folds at the compute
    assert (len(acc_calls), len(mse_calls)) == (1, 4)
    assert count("deferred.fold_calls", shape="ragged") - before == 4
    _equal_states(col.metrics["acc"], jacc)
    _equal_states(col.metrics["mse"], jmse)


@pytest.mark.parametrize("case", list(_EXACT))
def test_an_exact_fold_gives_integer_counts_for_any_split(case):
    """The trait's promise: integer states, integer deltas, and the deltas
    of any split of the rows adding up to the whole's, bit for bit."""
    make_port, _, make_batch = _EXACT[case]
    rng = np.random.default_rng(107)
    for seed in range(3):
        m = make_port()
        cls = type(m)
        assert cls._fold_exact
        assert all(not v.is_floating_point() for v in m.state_dict().values())
        m.update(*make_batch(rng, 40))
        whole = m._pending[-1]
        if seed == 1:
            # int32 labels and predicted classes, where the form allows them
            whole = tuple(a.to(torch.int32) if not a.is_floating_point() else a for a in whole)
        deltas = cls._fold_fn(*whole, *m._fold_params)
        assert all(d.dtype in (torch.int32, torch.int64) for d in deltas.values())
        cut = int(rng.integers(1, 40))
        head = cls._fold_fn(*(a[:cut] for a in whole), *m._fold_params)
        tail = cls._fold_fn(*(a[cut:] for a in whole), *m._fold_params)
        for name, d in deltas.items():
            assert torch.equal(head[name] + tail[name], d)


def _deferring_classes():
    import torcheval_tpu_torch.metrics.sliced  # noqa: F401  (its fold members)
    from torcheval_tpu_torch.metrics.deferred import DeferredFoldMixin

    seen, todo = set(), [DeferredFoldMixin]
    while todo:
        for sub in todo.pop().__subclasses__():
            if sub not in seen:
                seen.add(sub)
                todo.append(sub)
    return seen


def test_only_the_accuracies_set_the_exact_trait():
    exact = {c for c in _deferring_classes() if c._fold_exact}
    assert exact == {T.MulticlassAccuracy, T.BinaryAccuracy, T.MultilabelAccuracy, T.TopKMultilabelAccuracy}


# (port metric, one batch of its update arguments): per-chunk folds whose
# deltas or states are floats (sums, extrema, float thresholds)
_FLOAT_FOLDS = {
    "BinaryNormalizedEntropy": (lambda: T.BinaryNormalizedEntropy(device=CPU), _binary),
    "ClickThroughRate": (lambda: T.ClickThroughRate(device=CPU), lambda rng, n: (rng.integers(0, 2, n),)),
    "WeightedCalibration": (lambda: T.WeightedCalibration(device=CPU), _binary),
    "Sum": (lambda: T.Sum(device=CPU), lambda rng, n: (rng.random(n).astype(np.float32),)),
    "Mean": (lambda: T.Mean(device=CPU), lambda rng, n: (rng.random(n).astype(np.float32),)),
    "Max": (lambda: T.Max(device=CPU), lambda rng, n: (rng.random(n).astype(np.float32),)),
    "Min": (lambda: T.Min(device=CPU), lambda rng, n: (rng.random(n).astype(np.float32),)),
    "MeanSquaredError": (
        lambda: T.MeanSquaredError(device=CPU),
        lambda rng, n: (rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)),
    ),
    "R2Score": (
        lambda: T.R2Score(device=CPU),
        lambda rng, n: (rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)),
    ),
    "NDCG": (lambda: T.NDCG(k=3, device=CPU), _multilabel),
    "BinaryBinnedPrecisionRecallCurve": (
        lambda: T.BinaryBinnedPrecisionRecallCurve(threshold=5, device=CPU), _binary
    ),
}


@pytest.mark.parametrize("name", list(_FLOAT_FOLDS))
def test_a_fold_with_a_float_delta_or_state_leaves_the_trait_unset(name):
    make_port, make_batch = _FLOAT_FOLDS[name]
    m = make_port()
    cls = type(m)
    assert cls._fold_per_chunk
    m.update(*make_batch(np.random.default_rng(109), 16))
    deltas = cls._fold_fn(*m._pending[-1], *m._fold_params)
    floats = [v for v in (*deltas.values(), *m.state_dict().values()) if v.is_floating_point()]
    assert floats and not cls._fold_exact


@pytest.mark.parametrize("name", ["Max", "Min"])
def test_extrema_state_threads_through_the_stacked_fold(name):
    rng = np.random.default_rng(53)
    rows = rng.random((5, 32)).astype(np.float32)
    m, jm = getattr(T, name)(device=CPU), getattr(J, name)()
    for row in rows:  # five same-shape batches: one stacked fold
        m.update(row)
        jm.update(row)
    assert float(m.compute()) == float(jm.compute()) == float(getattr(rows, name.lower())())
    m.update(rows[0] + 10.0)
    jm.update(rows[0] + 10.0)
    assert float(m.compute()) == float(jm.compute())


@pytest.mark.parametrize("kind", ["bfloat16", "float16"])
def test_half_precision_extrema_keep_their_type_through_a_window(kind):
    rows = np.random.default_rng(59).standard_normal((4, 16)).astype(np.float32)
    m = T.Max(device=CPU)
    for row in rows:
        m.update(torch.from_numpy(row).to(getattr(torch, kind)))
    jm = J.Max()
    for row in rows:
        jm.update(jnp.asarray(row).astype(getattr(jnp, kind)))
    got, want = m.compute(), jm.compute()
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == kind
    assert float(got) == float(want)


def test_int_counter_meets_float_delta_in_the_stacked_fold():
    rng = np.random.default_rng(61)
    x, t, w = (rng.random(16).astype(np.float32) for _ in range(3))
    m, jm = T.MeanSquaredError(device=CPU), J.MeanSquaredError()
    for _ in range(3):
        m.update(x, t, sample_weight=w)
        jm.update(x, t, sample_weight=w)
    assert m.state_dict()["sum_weight"].dtype == torch.float32
    _equal_states(m, jm)
    _close(m.compute(), jm.compute())


@pytest.mark.parametrize("name", ["NDCG", "MAP", "RecallAtK"])
def test_retrieval_batches_fold_one_by_one_like_jax(name):
    rng = np.random.default_rng(67)
    m, jm = getattr(T, name)(k=3, device=CPU), getattr(J, name)(k=3)
    for _ in range(4):
        x = rng.random((8, 20)).astype(np.float32)
        rel = (rng.random((8, 20)) < 0.2).astype(np.float32)
        m.update(x, rel)
        jm.update(x, rel)
    assert len(m._pending) == 4
    _equal_states(m, jm)
    _close(m.compute(), jm.compute())


# --------------------------------------------- window steps per budget window
@pytest.mark.parametrize(
    "k,cap,steps",
    [(32, None, 1), (24, 8, 4), (11, 4, 3)],
    ids=["one-window", "three-valve-windows-and-a-compute", "two-valve-windows-and-a-remainder"],
)
def test_window_steps_per_budget_window_match_jax(k, cap, steps):
    """K updates and one compute(): one window step per valve window plus
    the compute's (which folds any remainder with the terminal computes)."""
    rng = np.random.default_rng(71)
    x, t = rng.random((37, 6)).astype(np.float32), rng.integers(0, 6, 37)
    col = T.MetricCollection({
        "acc": T.MulticlassAccuracy(num_classes=6, device=CPU),
        "f1": T.MulticlassF1Score(num_classes=6, average="macro", device=CPU),
        "top2": T.MulticlassAccuracy(num_classes=6, k=2, device=CPU),
    })
    jcol = J.MetricCollection({
        "acc": J.MulticlassAccuracy(num_classes=6),
        "f1": J.MulticlassF1Score(num_classes=6, average="macro"),
        "top2": J.MulticlassAccuracy(num_classes=6, k=2),
    })
    if cap is not None:
        col["acc"]._DEFER_MAX_CHUNKS = jcol["acc"]._DEFER_MAX_CHUNKS = cap
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    jx, jt = jnp.asarray(x), jnp.asarray(t)
    counts = _Counts()
    with _jax_counts() as jax_read:
        for _ in range(k):
            col.update(tx, tt)
            jcol.update(jx, jt)
        assert counts()["window_steps"] == jax_read()["window_steps"] == steps - 1
        got, want = col.compute(), jcol.compute()
        jax_c = jax_read()
    c = counts()
    assert c["window_steps"] == jax_c["window_steps"] == steps
    assert c["window_step_batches"] == jax_c["window_step_batches"] == k
    assert c["folds"] == jax_c["folds"] == 0
    for name in got:
        _close(got[name], want[name])
    for name in col.metrics:
        _equal_states(col[name], jcol[name])


def test_valve_cadence_at_the_byte_budget_matches_jax():
    rng = np.random.default_rng(73)
    x, t = rng.random((64, 5)).astype(np.float32), rng.integers(0, 5, 64)
    col = T.MetricCollection(T.MulticlassAccuracy(num_classes=5, device=CPU))
    jcol = J.MetricCollection(J.MulticlassAccuracy(num_classes=5))
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    jx, jt = jnp.asarray(x), jnp.asarray(t)
    # three batches a window in each package's own byte count
    col["metric"]._DEFER_BUDGET_BYTES = 3 * (tx.nbytes + tt.nbytes)
    jcol["metric"]._DEFER_BUDGET_BYTES = 3 * (jx.nbytes + jt.nbytes)
    counts = _Counts()
    with _jax_counts() as jax_read:
        for i in range(1, 11):
            col.update(tx, tt)
            jcol.update(jx, jt)
            assert len(col._window.chunks) == len(jcol._window.chunks) == i % 3
            assert counts()["window_steps"] == jax_read()["window_steps"] == i // 3
        _close(col.compute(), jcol.compute())
        assert counts()["window_steps"] == jax_read()["window_steps"] == 4


def test_standalone_fold_plus_compute_is_one_window_step():
    rng = np.random.default_rng(79)
    x, t = rng.random((23, 6)).astype(np.float32), rng.integers(0, 6, 23)
    m = T.MulticlassAccuracy(num_classes=6, device=CPU)
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    counts = _Counts()
    for _ in range(5):
        m.update(tx, tt)
    assert counts() == {"window_steps": 0, "window_step_batches": 0, "folds": 0, "grouped": 0}
    got = m.compute()
    assert counts() == {"window_steps": 1, "window_step_batches": 5, "folds": 0, "grouped": 0}
    _close(got, J.MulticlassAccuracy(num_classes=6).update(x, t).compute())


def test_standalone_valve_at_the_chunk_cap_matches_jax():
    rng = np.random.default_rng(83)
    x, t = rng.random((16, 4)).astype(np.float32), rng.integers(0, 4, 16)
    m = T.MulticlassAccuracy(num_classes=4, device=CPU)
    jm = J.MulticlassAccuracy(num_classes=4)
    m._DEFER_MAX_CHUNKS = jm._DEFER_MAX_CHUNKS = 4
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    counts = _Counts()
    with _jax_counts() as jax_read:
        for _ in range(10):
            m.update(tx, tt)
            jm.update(x, t)
        assert counts()["folds"] == jax_read()["folds"] == 2
        assert len(m._pending) == len(jm._pending) == 2
        _close(m.compute(), jm.compute())
        c, jc = counts(), jax_read()
    assert c["window_steps"] == jc["window_steps"] == 1
    assert c["window_step_batches"] == jc["window_step_batches"] == 2


# ------------------------------------------------ the port's own contracts
def test_in_place_write_to_a_pending_batch_raises_at_the_fold():
    rng = np.random.default_rng(89)
    x, t = _batch(rng, 16)
    tx, tt = torch.from_numpy(x.copy()), torch.from_numpy(t.copy())
    m = T.MulticlassAccuracy(num_classes=4, device=CPU)
    m.update(tx, tt)
    tt[0] = (tt[0] + 1) % 4  # the caller reuses its buffer
    with pytest.raises(RuntimeError, match="MulticlassAccuracy.*modified in place.*fresh tensor"):
        m.compute()
    assert len(m._pending) == 1  # nothing folded, nothing dropped
    assert int(m.num_total) == 0
    # a fresh tensor per update folds as usual
    fresh = T.MulticlassAccuracy(num_classes=4, device=CPU)
    fresh.update(torch.from_numpy(x.copy()), torch.from_numpy(t.copy()))
    _close(fresh.compute(), J.MulticlassAccuracy(num_classes=4).update(x, t).compute())


def test_in_place_write_to_a_window_batch_raises_at_the_close():
    rng = np.random.default_rng(97)
    x, t = _batch(rng, 16)
    col = T.MetricCollection({
        "acc": T.MulticlassAccuracy(num_classes=4, device=CPU),
        "f1": T.MulticlassF1Score(num_classes=4, average="macro", device=CPU),
    })
    tx = torch.from_numpy(x.copy())
    col.update(tx, torch.from_numpy(t))
    col.update(tx, torch.from_numpy(t))
    tx.mul_(-1.0)
    with pytest.raises(RuntimeError, match="MulticlassAccuracy, MulticlassF1Score.*in place"):
        col.compute()
    with pytest.raises(RuntimeError, match="in place"):
        col.state_dicts()


def test_update_under_torch_func_vmap_folds_eagerly():
    rng = np.random.default_rng(101)
    xs = rng.random((3, 16, 4)).astype(np.float32)
    ts = rng.integers(0, 4, (3, 16))

    def step(x, t):
        m = T.MulticlassAccuracy(num_classes=4, device=CPU)
        m.update(x, t)
        assert m._pending == []  # folded at once, nothing wrapped is kept
        return m.compute()

    got = torch.func.vmap(step)(torch.from_numpy(xs), torch.from_numpy(ts))
    want = [J.MulticlassAccuracy(num_classes=4).update(x, t).compute() for x, t in zip(xs, ts)]
    _close(got.numpy(), np.asarray(want))


def test_update_under_torch_func_grad_folds_eagerly():
    rng = np.random.default_rng(103)
    x, t = rng.random(16).astype(np.float32), rng.random(16).astype(np.float32)

    def loss(inp):
        m = T.MeanSquaredError(device=CPU)
        m.update(inp, torch.from_numpy(t))
        assert m._pending == []
        return m.compute()

    grad = torch.func.grad(loss)(torch.from_numpy(x))
    _close(grad.numpy(), 2.0 * (x - t) / x.shape[0])
