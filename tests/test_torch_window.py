"""The port's shared evaluation window (``EvalWindow`` and ``window_step``,
``metrics/deferred.py``; the collection's lanes, ``metrics/collection.py``;
the sliced collection's, ``metrics/sliced.py``) against the JAX package's,
on the CPU.

The cases mirror ``tests/metrics/test_window_step.py``. Its donation cases
become their PyTorch counterparts: which windows own their batches, the
early release of owned batches, and folds that write state out of place
(no default tensor is shared, and a captured state tensor keeps its
value). Every lane (a member's ``state_dict`` or ``compute`` mid-window,
keyword arguments, signature changes, ragged batches, a member streamed
into directly, a member reset, one metric in two collections, dead
windows, overridden ``update``/``compute``) is held to the JAX collection
fed the same numpy inputs: integer states exactly, floats within rtol 1e-5.
The sliced collection's window, its capacity growth mid-window, and the
sync and data-parallel reads mid-window close the file.
"""

import gc
import io
import pickle
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu_torch.metrics as T
from torcheval_tpu_torch.metrics import deferred as D
from torcheval_tpu_torch.metrics import sliced as S
from torcheval_tpu_torch.metrics import toolkit as tk
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
    for name in got:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, w)


def _twins(members):
    """The same named members in both packages."""
    make = {
        "acc": (lambda: T.MulticlassAccuracy(num_classes=4, device=CPU),
                lambda: J.MulticlassAccuracy(num_classes=4)),
        "macro": (lambda: T.MulticlassAccuracy(average="macro", num_classes=4, device=CPU),
                  lambda: J.MulticlassAccuracy(average="macro", num_classes=4)),
        "f1": (lambda: T.MulticlassF1Score(num_classes=4, average="macro", device=CPU),
               lambda: J.MulticlassF1Score(num_classes=4, average="macro")),
    }
    port = T.MetricCollection({m: make[m][0]() for m in members})
    ref = J.MetricCollection({m: make[m][1]() for m in members})
    return port, ref


def _check(port, ref):
    got, want = port.compute(), ref.compute()
    for name in got:
        _close(got[name], want[name])
        _equal_states(port[name], ref[name])


# ------------------------------------------------ ownership and early release
def test_window_owns_only_the_batches_it_placed():
    rng = np.random.default_rng(1)
    x, t = _batch(rng)
    col = T.MetricCollection(T.MulticlassAccuracy(num_classes=4, device=CPU))
    for _ in range(3):
        col.update(x, t)  # numpy: the collection's placement copies
    assert col._window.owned and len(col._window.chunks) == 3
    held = T.MetricCollection(T.MulticlassAccuracy(num_classes=4, device=CPU))
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    for _ in range(3):
        held.update(tx, tt)  # the caller's tensors
    assert not held._window.owned
    _close(col.compute(), held.compute())
    assert torch.equal(tt, torch.from_numpy(t))  # the caller's tensors are intact


def test_mixed_eager_member_blocks_ownership():
    rng = np.random.default_rng(2)
    x = rng.random(64).astype(np.float32)
    t = (rng.random(64) < 0.5).astype(np.float32)
    col = T.MetricCollection({"bacc": T.BinaryAccuracy(device=CPU), "auroc": T.BinaryAUROC(device=CPU)})
    col.update(x, t)
    assert not col._window.owned  # the AUROC's cache may hold the tensors
    ref = J.MetricCollection({"bacc": J.BinaryAccuracy(), "auroc": J.BinaryAUROC()})
    ref.update(x, t)
    _check(col, ref)


@pytest.mark.parametrize("owned", [True, False], ids=["owned", "caller"])
def test_owned_batches_are_released_before_the_fold_math(monkeypatch, owned):
    rng = np.random.default_rng(3)
    x, t = _batch(rng)
    col = T.MetricCollection(T.MulticlassAccuracy(num_classes=4, device=CPU))
    feed = (x, t) if owned else (torch.from_numpy(x), torch.from_numpy(t))
    for _ in range(3):
        col.update(*feed)
    first = weakref.ref(col._window.chunks[0][0])
    seen = []
    combine = D._combine

    def spy(members, outs):
        seen.append((first() is None, len(col._window.chunks)))
        return combine(members, outs)

    monkeypatch.setattr(D, "_combine", spy)
    got = col.compute()
    assert seen == ([(True, 0)] if owned else [(False, 3)])
    _close(got, J.MulticlassAccuracy(num_classes=4).update(np.concatenate([x] * 3), np.concatenate([t] * 3)).compute())


def test_folds_write_state_out_of_place_and_defaults_are_not_shared():
    rng = np.random.default_rng(4)
    x, t = _batch(rng)
    a = T.MulticlassAccuracy(num_classes=4, device=CPU)
    b = T.MulticlassAccuracy(num_classes=4, device=CPU)
    assert a.num_total is not b.num_total
    assert a._state_name_to_default["num_total"] is not b._state_name_to_default["num_total"]
    col = T.MetricCollection(a)
    col.update(x, t)
    captured = a.num_total
    sd = col.state_dicts()["metric"]  # folds, then copies
    col.update(x, t)
    col.compute()
    assert int(captured) == 0  # the fold replaced the tensor, it did not write it
    assert int(sd["num_total"]) == x.shape[0]
    assert int(b.num_total) == 0 and int(a._state_name_to_default["num_total"]) == 0
    assert int(T.MulticlassAccuracy(num_classes=4, device=CPU).num_total) == 0


def test_mid_window_state_dict_round_trips_bit_identical():
    rng = np.random.default_rng(5)
    x, t = _batch(rng, 48)
    m = T.MulticlassAccuracy(num_classes=4, device=CPU)
    col = T.MetricCollection(m)
    col.update(x, t)
    col.update(x, t)
    assert col._window.chunks
    buf = io.BytesIO()
    torch.save(m.state_dict(), buf)  # folds before it serialises
    assert col._window.chunks == []
    fresh = T.MulticlassAccuracy(num_classes=4, device=CPU)
    fresh.load_state_dict(torch.load(io.BytesIO(buf.getvalue())))
    for name in ("num_correct", "num_total"):
        assert torch.equal(getattr(fresh, name), m.state_dict()[name])
    ref = J.MulticlassAccuracy(num_classes=4).update(x, t).update(x, t)
    _equal_states(fresh, ref)


# -------------------------------------------------------------------- lanes
def test_member_state_dict_mid_window_drains_the_window():
    rng = np.random.default_rng(6)
    x, t = _batch(rng)
    col, ref = _twins(["acc", "f1"])
    col.update(x, t)
    ref.update(x, t)
    assert col._window.chunks
    sd = col["acc"].state_dict()  # one member's read drains the shared window
    assert int(sd["num_total"]) == x.shape[0]
    assert col._window.chunks == []
    _check(col, ref)  # the sibling's contribution survived


@pytest.fixture
def obs_on():
    """The obs registry on (and reset): it counts the window steps."""
    with recording():
        yield


def test_member_compute_mid_window_rides_the_window_close(obs_on):
    rng = np.random.default_rng(7)
    x, t = _batch(rng)
    col, ref = _twins(["acc", "f1"])
    col.update(x, t)
    ref.update(x, t)
    steps = count("deferred.window_steps")
    _close(col["acc"].compute(), ref["acc"].compute())
    assert count("deferred.window_steps") == steps + 1 and col._window.chunks == []
    _check(col, ref)


def test_kwargs_lane_matches_jax():
    rng = np.random.default_rng(8)
    col = T.MetricCollection(T.MeanSquaredError(device=CPU))
    ref = J.MetricCollection(J.MeanSquaredError())
    for _ in range(3):
        x, t, w = (rng.random(32).astype(np.float32) for _ in range(3))
        col.update(x, t, sample_weight=w)
        ref.update(x, t, sample_weight=w)
    assert col._window.chunks == [] and len(col["metric"]._pending) == 3
    _close(col.compute(), ref.compute())
    _equal_states(col["metric"], ref["metric"])


def test_signature_change_mid_stream_through_collection():
    rng = np.random.default_rng(9)
    col, ref = _twins(["acc"])
    t1 = rng.integers(0, 4, 16)
    x2, t2 = _batch(rng, 24)
    for c in (col, ref):
        c.update(t1.astype(np.float32), t1)
        c.update(t1.astype(np.float32), t1)
        c.update(x2, t2)
    assert len(col._window.chunks) == 1
    _check(col, ref)


def test_ragged_batch_sizes_share_one_window():
    rng = np.random.default_rng(10)
    x, t = _batch(rng, 60)
    col, ref = _twins(["acc", "macro", "f1"])
    for c in (col, ref):
        c.update(x[:20], t[:20])
        c.update(x[20:], t[20:])
    assert len(col._window.chunks) == 2
    _check(col, ref)


def test_direct_member_stream_interleaved_with_window():
    rng = np.random.default_rng(11)
    (x, t), (ex, et) = _batch(rng, 32), _batch(rng, 16)
    col, ref = _twins(["acc", "f1"])
    for c in (col, ref):
        c.update(x, t)
        c["acc"].update(ex, et)  # acc only, outside the collection
        c.update(x, t)
    _check(col, ref)


def test_member_reset_mid_window_keeps_sibling_contributions():
    rng = np.random.default_rng(12)
    (x, t), (x2, t2) = _batch(rng, 20), _batch(rng, 12)
    col, ref = _twins(["acc", "macro"])
    for c in (col, ref):
        c.update(x, t)
        c["acc"].reset()  # folds the window for the sibling, then wipes acc
        c.update(x2, t2)
    _check(col, ref)


def test_metric_in_two_collections_drains_both_windows():
    rng = np.random.default_rng(13)
    (x, t), (x2, t2), (x3, t3) = _batch(rng, 32), _batch(rng, 16), _batch(rng, 8)
    m = T.MulticlassAccuracy(num_classes=4, device=CPU)
    jm = J.MulticlassAccuracy(num_classes=4)
    cols = [T.MetricCollection({"acc": m}), T.MetricCollection({"acc": m})]
    jcols = [J.MetricCollection({"acc": jm}), J.MetricCollection({"acc": jm})]
    cols[0].update(x, t)
    jcols[0].update(x, t)
    assert int(m.state_dict()["num_total"]) == 32
    cols[1].update(x2, t2)
    jcols[1].update(x2, t2)
    _close(m.compute(), jm.compute())  # closes the second window with the compute
    cols[0].update(x3, t3)
    jcols[0].update(x3, t3)
    _close(cols[1].compute()["acc"], jcols[1].compute()["acc"])  # drains the first
    _equal_states(m, jm)


def test_dead_collection_windows_are_pruned_not_leaked():
    rng = np.random.default_rng(14)
    x, t = _batch(rng, 16)
    m = T.MulticlassAccuracy(num_classes=4, device=CPU)
    for _ in range(5):  # re-wrapped per epoch, a window left open each time
        col = T.MetricCollection({"acc": m})
        col.update(x, t)
        del col
    gc.collect()
    assert int(m.state_dict()["num_total"]) == 80  # the orphaned batches count
    assert len(m._defer_windows) == 0


def test_rewrapping_per_epoch_does_not_accumulate_dead_windows():
    rng = np.random.default_rng(15)
    m, jm = T.Mean(device=CPU), J.Mean()
    for _ in range(6):
        xs = rng.random(16).astype(np.float32)
        col = T.MetricCollection(m)
        col.update(xs)
        col.compute()
        J.MetricCollection(jm).update(xs).compute()
        del col
    assert len(m._defer_windows) <= 1
    _close(m.compute(), jm.compute())


def test_collection_reset_drops_the_window():
    col = T.MetricCollection(T.Mean(device=CPU))
    col.update(np.arange(8.0, dtype=np.float32))
    col.reset()
    assert col._window.chunks == []
    col.update(np.full(4, 2.0, dtype=np.float32))
    assert float(col.compute()) == 2.0


def test_repeated_compute_is_stable():
    rng = np.random.default_rng(16)
    x, t = _batch(rng)
    col, ref = _twins(["acc", "f1"])
    col.update(x, t)
    ref.update(x, t)
    first, second = col.compute(), col.compute()  # the second step folds nothing
    for name in first:
        assert torch.equal(first[name], second[name])
    _check(col, ref)


def test_transform_updates_fall_back_to_the_member_lane():
    rng = np.random.default_rng(17)
    xs = rng.random((2, 16, 4)).astype(np.float32)
    ts = rng.integers(0, 4, (2, 16))

    def step(x, t):
        col = T.MetricCollection(T.MulticlassAccuracy(num_classes=4, device=CPU))
        col.update(x, t)
        assert col._window.chunks == [] and col["metric"]._pending == []
        return col.compute()

    got = torch.func.vmap(step)(torch.from_numpy(xs), torch.from_numpy(ts))
    want = [J.MulticlassAccuracy(num_classes=4).update(x, t).compute() for x, t in zip(xs, ts)]
    _close(got.numpy(), np.asarray(want))


def test_mixed_vmap_and_scan_members_share_one_window():
    rng = np.random.default_rng(18)
    col = T.MetricCollection({
        "topk": T.TopKMultilabelAccuracy(criteria="hamming", k=2, device=CPU),
        "ml": T.MultilabelAccuracy(criteria="hamming", device=CPU),
        "ndcg": T.NDCG(k=3, device=CPU),
    })
    ref = J.MetricCollection({
        "topk": J.TopKMultilabelAccuracy(criteria="hamming", k=2),
        "ml": J.MultilabelAccuracy(criteria="hamming"),
        "ndcg": J.NDCG(k=3),
    })
    for _ in range(4):
        x = rng.random((16, 8)).astype(np.float32)
        t = (rng.random((16, 8)) > 0.5).astype(np.float32)
        col.update(x, t)
        ref.update(x, t)
    assert len(col._window.chunks) == 4
    _check(col, ref)


def test_subclassed_update_override_runs_every_batch():
    class CountingAccuracy(T.MulticlassAccuracy):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.calls = 0

        def update(self, input, target):
            self.calls += 1
            return super().update(input, target)

    rng = np.random.default_rng(19)
    x, t = _batch(rng, 48)
    m = CountingAccuracy(num_classes=4, device=CPU)
    col = T.MetricCollection(m)
    assert not col._window_armable
    for i in range(3):
        col.update(x[i * 16:(i + 1) * 16], t[i * 16:(i + 1) * 16])
    assert m.calls == 3
    _close(col.compute(), J.MulticlassAccuracy(num_classes=4).update(x, t).compute())
    assert T.MetricCollection(T.MulticlassAccuracy(num_classes=4, device=CPU))._window_armable


def test_subclassed_compute_override_is_honored():
    class PercentAccuracy(T.MulticlassAccuracy):
        def compute(self):
            return super().compute() * 100.0

    rng = np.random.default_rng(20)
    x, t = _batch(rng)
    col = T.MetricCollection({"acc": PercentAccuracy(num_classes=4, device=CPU)})
    assert col._window_compute_keys == ()
    col.update(x, t)
    _close(col.compute()["acc"], J.MulticlassAccuracy(num_classes=4).update(x, t).compute() * 100.0)
    assert T.MetricCollection(
        {"acc": T.MulticlassAccuracy(num_classes=4, device=CPU)}
    )._window_compute_keys == ("acc",)


# ------------------------------------------------------------------ sliced
def _sliced_stream(seed, n_batches=5, n=40, cohorts=9):
    rng = np.random.default_rng(seed)
    return [
        (rng.integers(0, cohorts, n) * 7 + 3, rng.random(n).astype(np.float32),
         (rng.random(n) < 0.5).astype(np.float32))
        for _ in range(n_batches)
    ]


def _check_sliced(got, want):
    for name in got:
        np.testing.assert_array_equal(got[name]["slice_ids"], np.asarray(want[name]["slice_ids"]))
        _close(got[name]["values"].numpy(), np.asarray(want[name]["values"]))


def test_sliced_collection_rides_one_window_with_one_scatter_per_group(monkeypatch, obs_on):
    """Five batches, three members: the window folds once, with one segment
    scatter per delta group (the accuracy pair, the Mean pair, the Max)."""
    calls = []
    scatter = S.segment_scatter

    def counting(vals, rows, num_segments, **kw):
        calls.append(tuple(vals.shape))
        return scatter(vals, rows, num_segments, **kw)

    monkeypatch.setattr(S, "segment_scatter", counting)
    stream = _sliced_stream(21)
    port = T.SlicedMetricCollection(
        {"acc": T.BinaryAccuracy(device=CPU)}, capacity=64
    )
    agg = T.SlicedMetricCollection({"mean": T.Mean(device=CPU), "max": T.Max(device=CPU)}, capacity=64)
    jport = J.SlicedMetricCollection({"acc": J.BinaryAccuracy()}, capacity=64)
    jagg = J.SlicedMetricCollection({"mean": J.Mean(), "max": J.Max()}, capacity=64)
    steps = count("deferred.window_steps")
    for ids, s, t in stream:
        port.update(ids, s, t)
        agg.update(ids, s)
        jport.update(ids, s, t)
        jagg.update(ids, s)
    assert calls == [] and len(port._window.chunks) == len(stream)
    _check_sliced({**port.compute(), **agg.compute()}, {**jport.compute(), **jagg.compute()})
    rows = sum(len(ids) for ids, _, _ in stream)
    assert sorted(calls) == sorted([(rows, 2), (rows, 2), (rows,)])
    assert count("deferred.window_steps") == steps + 2  # one window step per collection


def test_sliced_capacity_growth_mid_window_matches_jax():
    stream = _sliced_stream(22, cohorts=30)
    port = T.SlicedMetricCollection({"mean": T.Mean(device=CPU), "max": T.Max(device=CPU)}, capacity=4)
    ref = J.SlicedMetricCollection({"mean": J.Mean(), "max": J.Max()}, capacity=4)
    for ids, s, _ in stream:
        port.update(ids, s)
        ref.update(ids, s)
    assert port.slice_table.capacity > 4  # grew while the window was open
    assert len(port._window.chunks) == len(stream)
    _check_sliced(port.compute(), ref.compute())
    for name in port.metrics:
        _equal_states(port.metrics[name], ref.metrics[name])


def test_sliced_state_dicts_mid_window_and_merge():
    stream = _sliced_stream(23)
    a = T.SlicedMetricCollection({"acc": T.BinaryAccuracy(device=CPU)}, capacity=16)
    b = T.SlicedMetricCollection({"acc": T.BinaryAccuracy(device=CPU)}, capacity=16)
    ja = J.SlicedMetricCollection({"acc": J.BinaryAccuracy()}, capacity=16)
    jb = J.SlicedMetricCollection({"acc": J.BinaryAccuracy()}, capacity=16)
    for i, (ids, s, t) in enumerate(stream):
        (a if i % 2 else b).update(ids, s, t)
        (ja if i % 2 else jb).update(ids, s, t)
    sd = a.state_dicts()  # mid-window: folds first
    assert a._window.chunks == [] and b._window.chunks
    jsd = ja.state_dicts()
    for k in sd["acc"]:
        np.testing.assert_array_equal(sd["acc"][k].numpy(), np.asarray(jsd["acc"][k]))
    a.merge_collections([b])
    ja.merge_collections([jb])
    _check_sliced(a.compute(), ja.compute())


# ------------------------------------------------ sync and data parallelism
@pytest.fixture
def echo_world(monkeypatch):
    """A world of 2 in which the other rank holds this rank's states."""
    monkeypatch.setattr(tk._dist, "world_size", lambda group=None: 2)
    monkeypatch.setattr(tk._dist, "rank", lambda group=None: 0)
    monkeypatch.setattr(tk._dist, "all_gather_stacked", lambda x, pg: torch.stack([x, x]))
    monkeypatch.setattr(tk._dist, "collective_device", lambda pg: torch.device("cpu"))


def test_sync_mid_window_drains_every_window(echo_world):
    rng = np.random.default_rng(24)
    x, t = _batch(rng, 40)
    col, ref = _twins(["acc", "macro", "f1"])
    col.update(x, t)
    ref.update(x, t)
    assert col._window.chunks
    out = tk.sync_and_compute_collection(col.metrics, recipient_rank="all")
    assert col._window.chunks == []  # _prepare_for_merge_state drained it
    # the stream seen twice: the counts double, the values stay
    for name in out:
        _close(out[name], ref.compute()[name])
    synced = tk.get_synced_metric(col["f1"], recipient_rank="all")
    assert torch.equal(synced.num_tp, 2 * col["f1"].state_dict()["num_tp"])
    m = T.MulticlassAccuracy(num_classes=4, device=CPU).update(x, t)
    assert m._pending
    synced = tk.get_synced_metric(m, recipient_rank="all")
    assert m._pending == [] and int(synced.num_total) == 2 * x.shape[0]


def test_sharded_evaluator_compute_mid_window(echo_world):
    from torcheval_tpu_torch.parallel import DataParallelMesh, ShardedEvaluator

    rng = np.random.default_rng(25)
    x, t = _batch(rng, 40)
    mesh = DataParallelMesh(size=2, rank=0, device=torch.device("cpu"))
    ev = ShardedEvaluator({
        "acc": T.MulticlassAccuracy(num_classes=4, device=CPU),
        "f1": T.MulticlassF1Score(num_classes=4, average="macro", device=CPU),
    }, mesh=mesh)
    ev.update(x, t)
    assert ev._collection._window.chunks
    out = ev.compute()
    assert ev._collection._window.chunks == []
    _, ref = _twins(["acc", "f1"])
    ref.update(x, t)
    want = ref.compute()
    for name in out:
        _close(out[name], want[name])
    assert int(ev.state_dicts()["acc"]["num_total"]) == x.shape[0]


def test_pickled_member_leaves_its_collection():
    rng = np.random.default_rng(26)
    x, t = _batch(rng)
    col, ref = _twins(["acc"])
    col.update(x, t)
    ref.update(x, t)
    clone = pickle.loads(pickle.dumps(col["acc"]))
    assert not hasattr(clone, "_defer_managed") and clone._pending == []
    _equal_states(clone, ref["acc"])
