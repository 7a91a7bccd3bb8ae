"""The port's sliced collection against the JAX package's, on the CPU.

Mirrors every case of ``tests/metrics/test_sliced.py`` that needs neither
the sketch member (``approx=`` curves) nor sharding. The same numpy
streams, made from a seed, go through ``torcheval_tpu``'s
``SlicedMetricCollection`` and the port's (templates on ``device="cpu"``,
where the segment sum runs its plain version). Slice ids must match
exactly; counts and values computed from counts exactly; float sums within
rtol 1e-5 (per-slice sums add in another order than the reference's).
"""

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
from torcheval_tpu.metrics.sliced import SliceTable as JaxSliceTable
from torcheval_tpu_torch.metrics import (
    MAP,
    BinaryAccuracy,
    BinaryAUROC,
    HitRate,
    Max,
    Mean,
    MeanSquaredError,
    MetricCollection,
    Min,
    MulticlassAccuracy,
    MultilabelAccuracy,
    SlicedMetricCollection,
    Sum,
    TopKMultilabelAccuracy,
)
from torcheval_tpu_torch.metrics.sliced import (
    SlicedResult,
    SliceTable,
    align_sliced_gathered,
    check_sliceable,
)
from torcheval_tpu_torch.utils.jax_state import load_jax_state_dicts, numpy_state_dicts

RTOL = 1e-5
CPU = "cpu"


def _batches(seed=0, n_batches=3, n=257, pool=13, id_scale=101):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        ids = rng.integers(0, pool, n).astype(np.int64) * id_scale - 7
        s = rng.random(n).astype(np.float32)
        t = (rng.random(n) < 0.4).astype(np.float32)
        out.append((ids, s, t))
    return out


def _values(res):
    v = res["values"]
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ------------------------------------------------------------------ table
class TestSliceTable:
    def test_first_seen_order_and_growth(self):
        t = SliceTable(2)
        rows, grew = t.intern(np.asarray([5, 9, 5, 7], np.int64))
        assert grew  # 3 distinct ids > capacity 2
        np.testing.assert_array_equal(rows, [0, 1, 0, 2])
        assert t.capacity == 4
        np.testing.assert_array_equal(t.registered_ids(), [5, 9, 7])
        rows2, grew2 = t.intern(np.asarray([7, 9], np.int64))
        assert not grew2
        np.testing.assert_array_equal(rows2, [2, 1])

    def test_negative_and_64bit_ids(self):
        t = SliceTable(4)
        ids = np.asarray([-(1 << 40), (1 << 41) + 3, -1, 0], np.int64)
        rows, _ = t.intern(ids)
        np.testing.assert_array_equal(rows, [0, 1, 2, 3])
        np.testing.assert_array_equal(t.registered_ids(), ids)

    def test_rejects_non_integer_columns(self):
        t = SliceTable(4)
        with pytest.raises(ValueError):
            t.intern(np.asarray([1.5, 2.5]))
        with pytest.raises(ValueError):
            t.intern(np.zeros((2, 2), np.int64))

    def test_replace_round_trip_and_duplicate_rejection(self):
        t = SliceTable(4)
        t.intern(np.asarray([3, 1, 2], np.int64))
        ids = t.registered_ids()
        t2 = SliceTable(2)
        t2.replace(ids, 8)
        np.testing.assert_array_equal(t2.registered_ids(), ids)
        assert t2.capacity == 8
        with pytest.raises(ValueError):
            t2.replace(np.asarray([1, 1], np.int64), 4)

    def test_same_rows_and_growth_as_the_jax_table(self):
        rng = np.random.default_rng(4)
        ours, theirs = SliceTable(3), JaxSliceTable(3)
        for _ in range(5):
            ids = (rng.zipf(1.3, 400) - 1) % 997 * 7919 + 13
            r1, g1 = ours.intern(ids)
            r2, g2 = theirs.intern(ids)
            np.testing.assert_array_equal(r1, r2)
            assert g1 == g2 and ours.capacity == theirs.capacity
        np.testing.assert_array_equal(ours.registered_ids(), theirs.registered_ids())


# ------------------------------------------------------------- parity
def _stream_binary(seed):
    return _batches(seed=seed)


def _stream_scores(seed, c=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        ids = rng.integers(0, 9, 181).astype(np.int64) * 11
        scores = rng.random((181, c)).astype(np.float32)
        labels = rng.integers(0, c, 181).astype(np.int32)
        out.append((ids, scores, labels))
    return out


def _stream_regression(seed):
    return [(ids, s, t * 2.0 - 0.5) for ids, s, t in _batches(seed=seed)]


def _stream_values(seed):
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(0, 6, 300).astype(np.int64) * 3 - 5, rng.standard_normal(300).astype(np.float32))
        for _ in range(3)
    ]


def _stream_multilabel(seed):
    rng = np.random.default_rng(seed)
    return [
        (
            rng.integers(0, 7, 150).astype(np.int64),
            rng.random((150, 4)).astype(np.float32),
            (rng.random((150, 4)) < 0.5).astype(np.float32),
        )
        for _ in range(3)
    ]


CASES = {
    "binary_accuracy": (lambda: J.BinaryAccuracy(), lambda: BinaryAccuracy(device=CPU), _stream_binary, True),
    "multiclass_micro": (
        lambda: J.MulticlassAccuracy(num_classes=5),
        lambda: MulticlassAccuracy(num_classes=5, device=CPU),
        _stream_scores,
        True,
    ),
    # macro: the counts are exact; the mean over classes sums five float32
    # ratios in another order
    "multiclass_macro": (
        lambda: J.MulticlassAccuracy(average="macro", num_classes=5),
        lambda: MulticlassAccuracy(average="macro", num_classes=5, device=CPU),
        _stream_scores,
        False,
    ),
    "multiclass_top2": (
        lambda: J.MulticlassAccuracy(num_classes=5, k=2),
        lambda: MulticlassAccuracy(num_classes=5, k=2, device=CPU),
        _stream_scores,
        True,
    ),
    "multilabel_hamming": (
        lambda: J.MultilabelAccuracy(criteria="hamming"),
        lambda: MultilabelAccuracy(criteria="hamming", device=CPU),
        _stream_multilabel,
        True,
    ),
    "mse": (lambda: J.MeanSquaredError(), lambda: MeanSquaredError(device=CPU), _stream_regression, False),
    "sum": (lambda: J.Sum(), lambda: Sum(device=CPU), _stream_values, False),
    "mean": (lambda: J.Mean(), lambda: Mean(device=CPU), _stream_values, False),
    "max": (lambda: J.Max(), lambda: Max(device=CPU), _stream_values, True),
    "min": (lambda: J.Min(), lambda: Min(device=CPU), _stream_values, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_per_slice_values_match_jax(case):
    make_jax, make_torch, stream, exact = CASES[case]
    batches = stream(7)
    jcol = J.SlicedMetricCollection({"m": make_jax()}, capacity=2)
    tcol = SlicedMetricCollection({"m": make_torch()}, capacity=2)  # several growths
    for b in batches:
        jcol.update(*b)
        tcol.update(*b)
    want, got = jcol.compute()["m"], tcol.compute()["m"]
    assert isinstance(got, SlicedResult)
    np.testing.assert_array_equal(got.slice_ids, want.slice_ids)
    if exact:
        np.testing.assert_array_equal(_values(got), _values(want))
    else:
        np.testing.assert_allclose(_values(got), _values(want), rtol=RTOL, atol=1e-6)
    # the states too: counts exactly, float sums within the tolerance
    jstates = {k: np.asarray(v) for k, v in jcol.state_dicts()["m"].items()}
    for name, value in tcol.state_dicts()["m"].items():
        value = value.numpy()
        assert value.shape == jstates[name].shape, name
        if np.issubdtype(value.dtype, np.integer):
            np.testing.assert_array_equal(value, jstates[name], err_msg=name)
        else:
            np.testing.assert_allclose(value, jstates[name], rtol=RTOL, atol=1e-6, err_msg=name)


def test_per_slice_accuracy_equals_the_standalone_metric_per_slice():
    batches = _batches()
    col = SlicedMetricCollection({"acc": BinaryAccuracy(device=CPU)}, capacity=2)
    for b in batches:
        col.update(*b)
    res = col.compute()["acc"]
    ids, s, t = (np.concatenate([b[i] for b in batches]) for i in range(3))
    assert res.num_slices == len(np.unique(ids))
    for n, sid in enumerate(res.slice_ids):
        m = ids == sid
        oracle = BinaryAccuracy(device=CPU).update(s[m], t[m])
        assert float(oracle.compute()) == float(_values(res)[n])


def test_repeated_compute_is_idempotent():
    col = SlicedMetricCollection({"acc": BinaryAccuracy(device=CPU), "mean": Mean(device=CPU)}, capacity=4)
    for b in _batches(seed=5):
        col.update(*b)
    first, second = col.compute(), col.compute()
    for key in ("acc", "mean"):
        np.testing.assert_array_equal(_values(first[key]), _values(second[key]))


# --------------------------------------------------------------- lifecycle
def _make_pair():
    return (
        SlicedMetricCollection({"acc": BinaryAccuracy(device=CPU)}, capacity=2),
        SlicedMetricCollection({"mean": Mean(device=CPU), "max": Max(device=CPU), "min": Min(device=CPU)}, capacity=2),
    )


def _feed(pair, batches):
    acc, agg = pair
    for ids, s, t in batches:
        acc.update(ids, s, t)
        agg.update(ids, s)


def _assert_same_by_id(got, want, exact):
    order_g, order_w = np.argsort(got.slice_ids), np.argsort(want.slice_ids)
    np.testing.assert_array_equal(got.slice_ids[order_g], want.slice_ids[order_w])
    g, w = _values(got)[order_g], _values(want)[order_w]
    if exact:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL)


def test_merge_collections_by_original_id_respects_each_reduction():
    batches = _batches(seed=13, n_batches=4, pool=17)
    whole, a, b = _make_pair(), _make_pair(), _make_pair()
    _feed(whole, batches)
    _feed(a, batches[:2])
    _feed(b, batches[2:])
    for mine, theirs in zip(a, b):
        mine.merge_collections([theirs])
    for got_col, want_col in zip(a, whole):
        got, want = got_col.compute(), want_col.compute()
        for key in got:
            # sum members within float order, max and min exactly
            _assert_same_by_id(got[key], want[key], exact=key != "mean")


def test_rejected_growth_rolls_back_the_id_table():
    col = SlicedMetricCollection({"acc": BinaryAccuracy(device=CPU)}, capacity=4)
    col.update(np.asarray([1, 2], np.int64), np.asarray([0.9, 0.1], np.float32), np.asarray([1.0, 0.0], np.float32))
    mark = (col.slice_table.count, col.slice_table.capacity)

    def boom(capacity):
        raise ValueError("segment-index (simulated)")

    col.metrics["acc"]._check_capacity = boom
    new = (np.arange(10, dtype=np.int64), np.zeros(10, np.float32), np.zeros(10, np.float32))
    with pytest.raises(ValueError, match="segment-index"):
        col.update(*new)
    assert (col.slice_table.count, col.slice_table.capacity) == mark
    del col.metrics["acc"].__dict__["_check_capacity"]
    col.update(*new)
    res = col.compute()["acc"]
    assert res.num_slices == 10  # {1, 2} and {0..9}
    assert float(res.value_of(1)) == 1.0


def test_rejected_merge_fails_closed_before_any_member_mutates():
    def make():
        return SlicedMetricCollection({"acc": BinaryAccuracy(device=CPU), "mean": Mean(device=CPU)}, capacity=2)

    batches = _batches(seed=23, n_batches=4, pool=17)
    a, b = make(), make()
    # both members take (ids, scores, targets): Mean averages the scores with
    # the targets as its weights
    for bt in batches[:2]:
        a.update(*bt)
    for bt in batches[2:]:
        b.update(*bt)
    acc = a.metrics["acc"]
    table_before = (a.slice_table.count, a.slice_table.capacity)
    states_before = {n: getattr(acc, n).clone() for n in acc._sliced_state_names}

    def boom(capacity):
        raise ValueError("segment-index (simulated)")

    a.metrics["mean"]._check_capacity = boom
    with pytest.raises(ValueError, match="segment-index"):
        a.merge_collections([b])
    assert (a.slice_table.count, a.slice_table.capacity) == table_before
    for n, before in states_before.items():
        assert torch.equal(getattr(acc, n), before)
    del a.metrics["mean"].__dict__["_check_capacity"]
    a.merge_collections([b])
    whole = make()
    for bt in batches:
        whole.update(*bt)
    got, want = a.compute(), whole.compute()
    _assert_same_by_id(got["acc"], want["acc"], exact=True)
    _assert_same_by_id(got["mean"], want["mean"], exact=False)


def test_partial_load_keeps_the_id_table():
    col = SlicedMetricCollection({"acc": BinaryAccuracy(device=CPU)}, capacity=4)
    for b in _batches(seed=3):
        col.update(*b)
    col.state_dicts()
    ids, s, t = _batches(seed=4, pool=40)[0]
    col.update(ids * 3, s, t)  # new cohorts after the id lanes were last read
    want = col.compute()["acc"]
    member = col.metrics["acc"]
    member.load_state_dict({"num_correct": member.num_correct.clone()}, strict=False)
    got = col.compute()["acc"]
    np.testing.assert_array_equal(got.slice_ids, want.slice_ids)
    np.testing.assert_array_equal(_values(got), _values(want))


def test_reset_forgets_cohorts():
    col = SlicedMetricCollection({"acc": BinaryAccuracy(device=CPU)}, capacity=4)
    col.update(*_batches(n_batches=1)[0])
    col.reset()
    assert col.slice_table.count == 0
    ids = np.asarray([77, 78], np.int64)
    col.update(ids, np.asarray([0.9, 0.1], np.float32), np.asarray([1.0, 0.0], np.float32))
    res = col.compute()["acc"]
    np.testing.assert_array_equal(res.slice_ids, ids)
    np.testing.assert_array_equal(_values(res), [1.0, 1.0])
    sd = col.state_dicts()["acc"]
    assert int(sd["slice_count"]) == 2


# -------------------------------------------------------------- validation
@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: BinaryAUROC(device=CPU), "approx"),
        (lambda: HitRate(device=CPU), "cannot be sliced"),
        (lambda: MAP(k=3, device=CPU), "cannot be sliced"),
        (lambda: TopKMultilabelAccuracy(k=2, device=CPU), "vmap"),
        (lambda: BinaryAccuracy(device=CPU).update(np.asarray([0.9], np.float32), np.asarray([1.0], np.float32)), "fresh"),
        (lambda: Max(device=CPU).update(np.asarray([3.0], np.float32)), "fresh"),
    ],
    ids=["exact_auroc", "hit_rate", "map", "topk_multilabel", "used_accuracy", "used_max"],
)
def test_unsliceable_members_reject_with_reason(make, match):
    with pytest.raises(ValueError, match=match):
        SlicedMetricCollection({"m": make()})


def test_update_rejects_kwargs_and_bad_columns():
    col = SlicedMetricCollection({"acc": BinaryAccuracy(device=CPU)}, capacity=4)
    with pytest.raises(ValueError):
        col.update(np.asarray([1]), np.asarray([0.5]), weight=1.0)
    with pytest.raises(ValueError):
        col.update(np.asarray([1.5]), np.asarray([0.5], np.float32))
    with pytest.raises(ValueError):
        col.update(np.asarray([1, 2], np.int64))
    with pytest.raises(ValueError, match="sample count"):
        col.update(
            np.asarray([1, 2, 3], np.int64),
            np.asarray([0.5, 0.5], np.float32),
            np.asarray([1.0, 0.0], np.float32),
        )


@pytest.mark.parametrize(
    "make",
    [
        lambda: BinaryAccuracy(device=CPU),
        lambda: MulticlassAccuracy(num_classes=3, device=CPU),
        lambda: MulticlassAccuracy(average=None, num_classes=3, device=CPU),
        lambda: MultilabelAccuracy(device=CPU),
        lambda: MeanSquaredError(device=CPU),
        lambda: Sum(device=CPU),
        lambda: Mean(device=CPU),
        lambda: Max(device=CPU),
        lambda: Min(device=CPU),
    ],
)
def test_sliceable_family_coverage(make):
    check_sliceable(make())


# ------------------------------------------------------------------ results
def test_sliced_result_accessors_and_dict_protocol():
    col = SlicedMetricCollection({"acc": BinaryAccuracy(device=CPU)}, capacity=4)
    col.update(
        np.asarray([9, 9, 4], np.int64),
        np.asarray([0.9, 0.1, 0.8], np.float32),
        np.asarray([1.0, 1.0, 1.0], np.float32),
    )
    res = col.compute()["acc"]
    np.testing.assert_array_equal(res.slice_ids, [9, 4])
    assert res.num_slices == 2
    assert float(res.value_of(4)) == 1.0
    assert res.as_dict()[9] == 0.5
    with pytest.raises(KeyError):
        res.value_of(123)
    assert sorted(res.keys()) == ["slice_ids", "values"]
    assert len(list(res.values())) == 2


def test_tuple_valued_results_are_tree_aware():
    ids = np.asarray([7, 8, 9], np.int64)
    precision = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    recall = precision + 100.0
    res = SlicedResult(ids, (precision, recall))
    d = res.as_dict()
    assert sorted(d) == [7, 8, 9]
    np.testing.assert_array_equal(d[9][0], precision[2].numpy())
    np.testing.assert_array_equal(d[9][1], recall[2].numpy())
    np.testing.assert_array_equal(res.value_of(8)[0].numpy(), precision[1].numpy())


# ------------------------------------------------------- replicas and state
def _fold_aligned(member, aligned):
    """The per-reduction fold a sync layer runs after the alignment."""
    out = {}
    for name, red in member._state_name_to_reduction.items():
        rows = np.stack([a[name] for a in aligned])
        if red.value == "sum":
            out[name] = rows.sum(0).astype(rows.dtype)
        elif red.value == "max":
            out[name] = rows.max(0)
        elif red.value == "min":
            out[name] = rows.min(0)
        else:  # NONE: the aligned id lanes are identical on every entry
            out[name] = rows[0]
    return out


def test_align_sliced_gathered_over_ragged_replicas_equals_one_stream():
    batches = _batches(seed=31, n_batches=6, pool=23)

    def make():
        return _make_pair()

    whole = make()
    replicas = [make(), make(), make()]
    _feed(whole, batches)
    for i, (ids, s, t) in enumerate(batches):
        # ragged: each replica sees its own subset of cohorts
        keep = (ids % 3) != i % 3
        _feed(replicas[i % 3], [(ids[keep], s[keep], t[keep])])
        _feed(replicas[(i + 1) % 3], [(ids[~keep], s[~keep], t[~keep])])
    synced = make()
    for c, col in enumerate(synced):
        for name, member in col.metrics.items():
            gathered = [r[c].metrics[name].state_dict() for r in replicas]
            aligned = align_sliced_gathered(member, gathered)
            assert all(int(a["slice_count"]) == int(aligned[0]["slice_count"]) for a in aligned)
            folded = _fold_aligned(member, aligned)
            member.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in folded.items()})
        got, want = col.compute(), whole[c].compute()
        for key in got:
            # the union is sorted by id
            np.testing.assert_array_equal(got[key].slice_ids, np.sort(want[key].slice_ids))
            _assert_same_by_id(got[key], want[key], exact=key != "mean")


def _jax_numpy_states(col):
    return {n: {k: np.asarray(v) for k, v in sd.items()} for n, sd in col.state_dicts().items()}


def test_sliced_state_carries_from_jax_and_back():
    batches = _batches(seed=41, pool=29)
    jcol = J.SlicedMetricCollection({"acc": J.BinaryAccuracy(), "mean": J.Mean()}, capacity=2)
    # one column set for both members: Mean takes the targets as weights
    for b in batches:
        jcol.update(*b)
    want = jcol.compute()
    # JAX -> port, onto a fresh smaller-capacity collection: the table and
    # the grown capacity are adopted from the id lanes
    tcol = SlicedMetricCollection({"acc": BinaryAccuracy(device=CPU), "mean": Mean(device=CPU)}, capacity=2)
    load_jax_state_dicts(tcol, _jax_numpy_states(jcol))
    np.testing.assert_array_equal(tcol.slice_table.registered_ids(), jcol.slice_table.registered_ids())
    assert tcol.slice_table.capacity == jcol.slice_table.capacity
    got = tcol.compute()
    np.testing.assert_array_equal(got["acc"].slice_ids, want["acc"].slice_ids)
    np.testing.assert_array_equal(_values(got["acc"]), _values(want["acc"]))
    np.testing.assert_allclose(_values(got["mean"]), _values(want["mean"]), rtol=RTOL)
    # the port keeps streaming, new cohorts included, then hands back
    extra = (batches[0][0] * 7 + 1, batches[0][1], batches[0][2])
    tcol.update(*extra)
    jcol.update(*extra)
    back = J.SlicedMetricCollection({"acc": J.BinaryAccuracy(), "mean": J.Mean()}, capacity=2)
    back.load_state_dicts(numpy_state_dicts(tcol))
    want2, got2 = jcol.compute(), back.compute()
    np.testing.assert_array_equal(got2["acc"].slice_ids, want2["acc"].slice_ids)
    np.testing.assert_array_equal(_values(got2["acc"]), _values(want2["acc"]))
    np.testing.assert_allclose(_values(got2["mean"]), _values(want2["mean"]), rtol=RTOL)


def test_plain_collection_state_carries_both_ways():
    rng = np.random.default_rng(2)
    x = rng.random(300).astype(np.float32)
    t = (rng.random(300) < 0.5).astype(np.float32)
    jcol = J.MetricCollection({"acc": J.BinaryAccuracy(), "mse": J.MeanSquaredError()})
    jcol.update(x, t)
    tcol = MetricCollection({"acc": BinaryAccuracy(device=CPU), "mse": MeanSquaredError(device=CPU)})
    load_jax_state_dicts(tcol, _jax_numpy_states(jcol))
    tcol.update(x[:100], t[:100])
    jcol.update(x[:100], t[:100])
    got, want = tcol.compute(), jcol.compute()
    for key in ("acc", "mse"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL)
    back = J.MetricCollection({"acc": J.BinaryAccuracy(), "mse": J.MeanSquaredError()})
    back.load_state_dicts(numpy_state_dicts(tcol))
    for key, value in back.compute().items():
        np.testing.assert_allclose(np.asarray(value), np.asarray(want[key]), rtol=RTOL)
