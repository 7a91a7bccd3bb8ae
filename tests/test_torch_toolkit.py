"""The port's sync toolkit in one process, against the JAX package's.

``_fold_states`` folds simulated rank dicts exactly as
``torcheval_tpu.metrics.toolkit._fold_states`` does on the same numpy
inputs; the descriptor matrix of a collection (round one of the wire) is
the JAX package's row for row; the WINDOW cut, the local helpers, the
world-size-1 warning, the argument checks and the ``timeout_s`` and
``on_failure`` contract hold, the last on a round stalled on purpose.
Exact comparisons throughout, except float folds within rtol 1e-5 and
atol 1e-8. Real multi-process worlds are in ``test_torch_sync.py``.
"""

import copy
import logging
import threading
from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
from torcheval_tpu.metrics import toolkit as jtk
from torcheval_tpu.metrics.state import Reduction as JR
from torcheval_tpu_torch.metrics import (
    BinaryAccuracy,
    BinaryAUROC,
    Max,
    MulticlassAccuracy,
    MulticlassF1Score,
    SlicedMetricCollection,
    Sum,
)
from torcheval_tpu_torch.metrics import toolkit as tk
from torcheval_tpu_torch.metrics.state import Reduction
from torcheval_tpu_torch.utils.test_utils import DummySumDictStateMetric, DummySumMetric

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


# ------------------------------------------------------------------ folding
def _rank_dicts(seed=0, world=3):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(world):
        cat_rows = [0, 5, 3][r % 3]
        out.append({
            "s": rng.standard_normal((4,)).astype(np.float32),
            "c": rng.integers(0, 100, (3,)).astype(np.int32),
            "mx": rng.standard_normal((2, 2)).astype(np.float32),
            "mn": rng.integers(-50, 50, (4,)).astype(np.int32),
            "cat": [rng.random(cat_rows).astype(np.float32)] if cat_rows else [],
            "none": np.asarray(7, np.int32),
            "win": deque([rng.random(2).astype(np.float32) for _ in range(r + 1)]),
        })
    return out


_REDS = {
    "s": "SUM", "c": "SUM", "mx": "MAX", "mn": "MIN", "cat": "CAT", "none": "NONE", "win": "WINDOW",
}


def test_fold_states_equals_jax_for_every_reduction():
    dicts = _rank_dicts()
    got = tk._fold_states(
        [{k: (deque(torch.from_numpy(x) for x in v) if isinstance(v, deque)
              else [torch.from_numpy(x) for x in v] if isinstance(v, list)
              else torch.from_numpy(v)) for k, v in d.items()} for d in dicts],
        {k: Reduction[v] for k, v in _REDS.items()},
    )
    want = jtk._fold_states(
        [{k: (deque(jnp.asarray(x) for x in v) if isinstance(v, deque)
              else [jnp.asarray(x) for x in v] if isinstance(v, list)
              else jnp.asarray(v)) for k, v in d.items()} for d in dicts],
        {k: JR[v] for k, v in _REDS.items()},
    )
    for name in ("c", "mx", "mn", "none"):
        np.testing.assert_array_equal(_np(got[name]), np.asarray(want[name]))
    np.testing.assert_allclose(_np(got["s"]), np.asarray(want["s"]), rtol=RTOL, atol=ATOL)
    assert len(got["cat"]) == len(want["cat"]) == 1
    np.testing.assert_array_equal(_np(got["cat"][0]), np.asarray(want["cat"][0]))
    assert len(got["win"]) == len(want["win"]) == 6
    for g, w in zip(got["win"], want["win"]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_fold_states_of_empty_caches_and_custom():
    empty = [{"cat": []}, {"cat": torch.zeros((0,))}]
    assert tk._fold_states(empty, {"cat": Reduction.CAT}) == {"cat": []}
    assert jtk._fold_states([{"cat": []}, {"cat": jnp.zeros((0,))}], {"cat": JR.CAT}) == {"cat": []}
    with pytest.raises(NotImplementedError, match="CUSTOM"):
        tk._fold_states([{"x": {}}], {"x": Reduction.CUSTOM})


# -------------------------------------------------------------- wire format
def test_dtype_codes_are_the_jax_packages():
    assert len(tk._CAT_DTYPES) == len(jtk._CAT_DTYPES)
    for t, j in zip(tk._CAT_DTYPES, jtk._CAT_DTYPES):
        assert str(t)[6:] == jnp.dtype(j).name


def _twin_collections():
    """The same collection in both packages, fed the same batches (one
    AUROC cache empty, one WINDOW-free mix of SUM, MAX, CAT and NONE)."""
    rng = np.random.default_rng(4)
    scores = rng.random((40, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 40)
    logits = rng.random(40).astype(np.float32)
    binary = (rng.random(40) < 0.4).astype(np.float32)
    port = {
        "acc": MulticlassAccuracy(average="macro", num_classes=5, device=CPU),
        "f1": MulticlassF1Score(num_classes=5, average=None, device=CPU),
        "auroc": BinaryAUROC(device=CPU),
        "compacting": BinaryAUROC(compaction_threshold=16, device=CPU),
        "empty": BinaryAUROC(device=CPU),
        "sum": Sum(device=CPU),
        "max": Max(device=CPU),
    }
    ref = {
        "acc": J.MulticlassAccuracy(average="macro", num_classes=5),
        "f1": J.MulticlassF1Score(num_classes=5, average=None),
        "auroc": J.BinaryAUROC(),
        "compacting": J.BinaryAUROC(compaction_threshold=16),
        "empty": J.BinaryAUROC(),
        "sum": J.Sum(),
        "max": J.Max(),
    }
    for metrics in (port, ref):
        for i in range(0, 40, 10):
            metrics["acc"].update(scores[i:i + 10], labels[i:i + 10])
            metrics["f1"].update(scores[i:i + 10], labels[i:i + 10])
            metrics["auroc"].update(logits[i:i + 10], binary[i:i + 10])
            metrics["compacting"].update(logits[i:i + 10], binary[i:i + 10])
            metrics["sum"].update(logits[i:i + 10])
            metrics["max"].update(logits[i:i + 10])
        for m in metrics.values():
            m._prepare_for_merge_state()
    return port, ref


def test_descriptor_matrix_is_the_jax_packages_row_for_row():
    port, ref = _twin_collections()
    got = tk._descriptor_matrix(port, tk._collection_entries(port))
    want = np.asarray(
        [jtk._schema_digest_row(ref)]
        + [jtk._encode_entry_descriptor(local) for _, _, _, local in jtk._collection_entries(ref)],
        dtype=np.int32,
    )
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "d0,maxlen",
    [([2, 2, 2, 2], 6), ([0, 5, 0, 1], 3), ([3, 3], 10), ([4, 0, 4], 4), ([1, 1, 1], 1)],
)
def test_window_keep_counts_equal_jax(d0, maxlen):
    got = tk._window_keep_counts(np.asarray(d0), maxlen)
    np.testing.assert_array_equal(got, jtk._window_keep_counts(np.asarray(d0), maxlen))
    assert got.sum() == min(maxlen, sum(d0))


def test_descriptor_of_scalars_empties_and_oversized_ranks():
    assert tk._encode_entry_descriptor(None) == jtk._encode_entry_descriptor(None)
    scalar = tk._encode_entry_descriptor(torch.tensor(3, dtype=torch.int64))
    assert scalar == jtk._encode_entry_descriptor(np.asarray(3, np.int64))
    big = torch.zeros((1,) * 6)
    assert tk._encode_entry_descriptor(big)[1] == 6
    with pytest.raises(NotImplementedError, match="rank 6"):
        tk._check_cat_descriptors("x", np.asarray([tk._encode_entry_descriptor(big)]))


# ------------------------------------------------------------ local helpers
def test_clone_reset_merge_and_to_device():
    a = DummySumMetric(device=CPU).update(torch.tensor([1.0, 2.0]))
    b = DummySumMetric(device=CPU).update(torch.tensor([4.0]))
    c = tk.clone_metric(a)
    assert c is not a and float(c.compute()) == 3.0
    merged = tk.merge_metrics([a, b])
    assert float(merged.compute()) == 7.0
    assert float(a.compute()) == 3.0 and float(b.compute()) == 4.0  # sources unchanged
    assert tk.merge_metrics([]) is None
    clones = tk.clone_metrics([a, b])
    assert [float(m.compute()) for m in tk.reset_metrics(clones)] == [0.0, 0.0]
    assert [m.device for m in tk.to_device([a, b], "cpu")] == [torch.device("cpu")] * 2


def test_world_of_one_warns_and_returns_the_input(caplog):
    m = Sum(device=CPU).update(torch.tensor([1.0, 2.0]))
    with caplog.at_level(logging.WARNING, logger=tk.__name__):
        assert tk.get_synced_metric(m) is m
        assert float(tk.sync_and_compute(m, recipient_rank="all")) == 3.0
        assert tk.get_synced_state_dict(m)["weighted_sum"] == 3.0
        out = tk.sync_and_compute_collection({"s": m, "t": Sum(device=CPU)})
    assert {k: float(v) for k, v in out.items()} == {"s": 3.0, "t": 0.0}
    assert sum("World size is 1" in r.message for r in caplog.records) == 4


@pytest.mark.parametrize("bad", [0, -1.0, float("inf"), float("nan"), "1"])
def test_timeout_s_must_be_positive_and_finite(bad):
    m = Sum(device=CPU)
    for fn in (tk.get_synced_metric, tk.sync_and_compute, tk.get_synced_state_dict):
        with pytest.raises(ValueError, match="timeout_s"):
            fn(m, timeout_s=bad)
    with pytest.raises(ValueError, match="timeout_s"):
        tk.sync_and_compute_collection({"m": m}, timeout_s=bad)


def test_recipient_and_policy_and_group_checks(monkeypatch):
    m = Sum(device=CPU)
    with pytest.raises(ValueError, match="recipient_rank"):
        tk.sync_and_compute(m, recipient_rank="some")
    with pytest.raises(ValueError, match="on_failure"):
        tk.sync_and_compute(m, on_failure="ignore")
    monkeypatch.setattr(tk._dist, "world_size", lambda group=None: 4)
    monkeypatch.setattr(tk._dist, "rank", lambda group=None: 0)
    with pytest.raises(ValueError, match="non-empty"):
        tk.sync_and_compute(m, processes=[])
    with pytest.raises(ValueError, match="out of range"):
        tk.sync_and_compute(m, processes=[0, 4])
    with pytest.raises(ValueError, match="not a member"):
        tk.sync_and_compute(m, processes=[1, 2])
    with pytest.raises(ValueError, match="recipient_rank 3"):
        tk.sync_and_compute(m, recipient_rank=3, processes=[0, 1])


# ------------------------------------------------------------ failed rounds
@pytest.fixture
def stalled_world(monkeypatch):
    """A world of 2 whose collectives never return (a dead peer)."""
    release = threading.Event()
    monkeypatch.setattr(tk._dist, "world_size", lambda group=None: 2)
    monkeypatch.setattr(tk._dist, "all_gather_stacked", lambda x, pg: release.wait())
    monkeypatch.setattr(tk.dist, "all_gather_object", lambda out, obj, group=None: release.wait())
    yield
    release.set()


def test_on_failure_local_returns_the_local_result_on_a_stalled_round(stalled_world, caplog):
    m = Sum(device=CPU).update(torch.tensor([1.0, 2.0]))
    before = tk._sync_failure.count
    synced = tk.get_synced_metric(m, recipient_rank=1, timeout_s=0.2, on_failure="local")
    assert synced is not m and float(synced.compute()) == 3.0
    assert float(tk.sync_and_compute(m, timeout_s=0.2, on_failure="local")) == 3.0
    out = tk.sync_and_compute_collection(
        {"s": m, "d": DummySumDictStateMetric(device=CPU)}, timeout_s=0.2, on_failure="local"
    )
    assert float(out["s"]) == 3.0
    assert tk._sync_failure.count - before == 3


def test_on_failure_raise_names_the_stalled_round(stalled_world):
    m = Sum(device=CPU).update(torch.tensor([1.0]))
    with pytest.raises(tk.SyncTimeoutError) as err:
        tk.sync_and_compute(m, timeout_s=0.2)
    assert (err.value.round, err.value.lane, err.value.timeout_s) == ("descriptor", "typed", 0.2)
    with pytest.raises(tk.SyncTimeoutError) as err:
        tk.sync_and_compute(DummySumDictStateMetric(device=CPU), timeout_s=0.2)
    assert (err.value.round, err.value.lane) == ("object", "object")


def test_a_round_that_fails_is_a_sync_round_error(monkeypatch):
    def dead_peer(x, pg):
        raise RuntimeError("connection reset by peer")

    monkeypatch.setattr(tk._dist, "world_size", lambda group=None: 2)
    monkeypatch.setattr(tk._dist, "all_gather_stacked", dead_peer)
    m = Sum(device=CPU).update(torch.tensor([5.0]))
    with pytest.raises(tk.SyncRoundError, match="connection reset") as err:
        tk.sync_and_compute(m, timeout_s=5.0)
    assert isinstance(err.value.__cause__, RuntimeError)
    assert float(tk.sync_and_compute(m, timeout_s=5.0, on_failure="local")) == 5.0


# ------------------------------------------------- an echo world, in-process
@pytest.fixture
def echo_world(monkeypatch):
    """A world of 2 in which the other rank holds this rank's states."""
    monkeypatch.setattr(tk._dist, "world_size", lambda group=None: 2)
    monkeypatch.setattr(tk._dist, "rank", lambda group=None: 0)
    monkeypatch.setattr(tk._dist, "all_gather_stacked", lambda x, pg: torch.stack([x, x]))
    monkeypatch.setattr(tk._dist, "collective_device", lambda pg: torch.device("cpu"))


def test_echo_world_doubles_counts_and_keeps_device_and_types(echo_world):
    port, _ = _twin_collections()
    before = tk._allgather_stacked.rounds
    out = tk.sync_and_compute_collection(port, recipient_rank="all")
    assert tk._allgather_stacked.rounds - before == 2
    for name in ("acc", "f1", "sum", "max"):
        local = port[name].compute()
        assert out[name].dtype == local.dtype and out[name].device == local.device
    synced = tk.get_synced_metric(port["f1"], recipient_rank="all")
    assert torch.equal(synced.num_tp, 2 * port["f1"].num_tp)
    assert synced.num_tp.dtype == torch.int32
    np.testing.assert_allclose(float(out["sum"]), 2 * float(port["sum"].compute()), rtol=RTOL)
    # the AUROC of a stream seen twice is the stream's
    np.testing.assert_allclose(float(out["auroc"]), float(port["auroc"].compute()), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(out["compacting"]), float(port["auroc"].compute()), rtol=RTOL, atol=ATOL)
    assert float(out["empty"]) == 0.5


def test_echo_world_half_precision_states_cross_the_wire(echo_world):
    m = Max(device=CPU).update(torch.tensor([1.5, -2.0]).bfloat16())
    synced = tk.get_synced_metric(m, recipient_rank="all")
    assert synced.max.dtype == torch.bfloat16 and float(synced.max) == 1.5
    a = BinaryAUROC(device=CPU).update(torch.rand(20).half(), (torch.rand(20) < 0.5).float())
    assert tk.get_synced_metric(a, recipient_rank="all").inputs[0].dtype == torch.float16


def test_echo_world_sliced_collection_equals_merged_replicas(echo_world):
    rng = np.random.default_rng(9)
    col = SlicedMetricCollection({"acc": BinaryAccuracy(device=CPU), "sum": Sum(device=CPU)}, capacity=4)
    for _ in range(2):
        col.update(rng.integers(0, 7, 50) * 13 - 5, rng.random(50).astype(np.float32),
                   (rng.random(50) < 0.5).astype(np.float32))
    merged = copy.deepcopy(col).merge_collections([copy.deepcopy(col)]).compute()
    out = tk.sync_and_compute_collection(dict(col.metrics), recipient_rank="all")
    for name in ("acc", "sum"):
        order = np.argsort(merged[name]["slice_ids"])
        np.testing.assert_array_equal(out[name]["slice_ids"], merged[name]["slice_ids"][order])
        np.testing.assert_allclose(out[name]["values"].numpy(), merged[name]["values"].numpy()[order],
                                   rtol=RTOL, atol=ATOL)
