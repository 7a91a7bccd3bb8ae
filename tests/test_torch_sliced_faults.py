"""Two faults of the port's slice-sharded ``SlicedMetricCollection`` against
the JAX package, each in a real gloo world on the CPU.

1. A sync of a slice-sharded member over its data ranks: four processes of
   ``python -m torcheval_tpu_torch.utils.test_utils.sharded_worker
   sliced_sync`` on a 2 x 2 ``("data", "slices")`` mesh, each data replica
   streaming its two of four batches into a ``Sum`` member, then
   ``sync_and_compute(..., processes=<its data ranks>)`` on every rank. The
   JAX toolkit gathers the unsharded layout and re-installs the shards on
   adoption (``torcheval_tpu/metrics/toolkit.py:724-755``).
2. Pickling a slice-sharded member or collection: two processes of the
   ``sliced_pickle`` scenario pickle them (a collective over the slice
   group), and this process, which has no process group, unpickles them as
   unsharded collections holding the global value, as the JAX package
   degrades a sharded member (``torcheval_tpu/metrics/sliced.py:509-522``).

Each world is killed after its own timeout (120 s). The oracles are the
port's unsharded collection and the JAX collection on the same batches:
ids and integer lanes exactly, float sums and means within rtol 1e-5.
"""

import os
import pickle
import tempfile

import numpy as np
import pytest

import torcheval_tpu.metrics as J
from torcheval_tpu_torch.metrics import BinaryAccuracy, BinaryAUROC, Max, Mean, SlicedMetricCollection, Sum
from torcheval_tpu_torch.utils.test_utils import sharded_worker as W

LAUNCH_TIMEOUT_S = 120
RTOL = 1e-5
SYNC_BATCHES = dict(n_unique=40, n_batches=4, seed=3)


def _by_id(ids, values) -> dict:
    return {str(int(i)): float(v) for i, v in zip(np.asarray(ids), np.asarray(values, np.float64))}


def _assert_same(got: dict, want: dict, exact: bool):
    assert sorted(got) == sorted(want)
    g = np.asarray([got[k] for k in sorted(want)])
    w = np.asarray([want[k] for k in sorted(want)])
    if exact:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL)


@pytest.fixture(scope="module")
def sync_world():
    with tempfile.TemporaryDirectory(prefix="torch_sliced_sync_") as outdir:
        yield W.launch_world("sliced_sync", outdir, LAUNCH_TIMEOUT_S)


@pytest.fixture(scope="module")
def pickle_world():
    with tempfile.TemporaryDirectory(prefix="torch_sliced_pickle_") as outdir:
        results = W.launch_world("sliced_pickle", outdir, LAUNCH_TIMEOUT_S, world=2)
        blobs = {}
        for name in ("member", "collection", "agg"):
            with open(os.path.join(outdir, f"{name}.pkl"), "rb") as f:
                blobs[name] = f.read()
        yield results, blobs


# ------------------------------------------------- fault 1: data-rank sync
def _sum_references():
    batches = W.sliced_batches(**SYNC_BATCHES)
    port = SlicedMetricCollection({"sum": Sum(device="cpu")}, capacity=64)
    jcol = J.SlicedMetricCollection({"sum": J.Sum()}, capacity=64)
    for ids, s, _ in batches:
        port.update(ids, s)
        jcol.update(ids, s)
    p, j = port.compute()["sum"], jcol.compute()["sum"]
    return _by_id(p.slice_ids, p["values"]), _by_id(j.slice_ids, j["values"])


def test_sharded_member_syncs_over_its_data_ranks(sync_world):
    port, jax_ref = _sum_references()
    for rank, res in enumerate(sync_world):
        # ranks (0, 2) and (1, 3) are the two data groups of the 2 x 2 mesh
        assert res["data_ranks"] == [rank % 2, rank % 2 + 2]
        _assert_same(res["synced"], port, exact=False)
        _assert_same(res["synced"], jax_ref, exact=False)


def test_synced_member_keeps_this_ranks_tiles(sync_world):
    for res in sync_world:
        # 40 cohorts over the union, padded to the 2 slice ranks' multiple
        assert res["synced_capacity"] == 40
        assert res["synced_tile_rows"] * 2 == res["synced_capacity"]


def test_sync_leaves_the_local_member_unchanged(sync_world):
    batches = W.sliced_batches(**SYNC_BATCHES)
    for rank, res in enumerate(sync_world):
        d = rank // 2  # the data coordinate: rows of the 2 x 2 mesh
        col = SlicedMetricCollection({"sum": Sum(device="cpu")}, capacity=64)
        for ids, s, _ in batches[2 * d : 2 * d + 2]:
            col.update(ids, s)
        want = col.compute()["sum"]
        _assert_same(res["local"], _by_id(want.slice_ids, want["values"]), exact=False)


# -------------------------------------------------------- fault 2: pickling
def _unsharded(agg=False):
    members = ({"mean": Mean(device="cpu"), "max": Max(device="cpu")} if agg else
               {"acc": BinaryAccuracy(device="cpu"), "auroc": BinaryAUROC(approx=1024, device="cpu")})
    return SlicedMetricCollection(members, capacity=64)


def _jax(agg=False):
    members = ({"mean": J.Mean(), "max": J.Max()} if agg else
               {"acc": J.BinaryAccuracy(), "auroc": J.BinaryAUROC(approx=1024)})
    return J.SlicedMetricCollection(members, capacity=64)


def _feed(col, batches, agg=False):
    for ids, s, t in batches:
        if agg:
            col.update(ids, s)
        else:
            col.update(ids, s, t)
    return col


def _per_member(out) -> dict:
    return {name: _by_id(r.slice_ids, r["values"]) for name, r in out.items()}


def _assert_members(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        _assert_same(got[name], want[name], exact=name not in ("mean",))


@pytest.mark.parametrize("agg", [False, True])
def test_sharded_collection_unpickles_unsharded_with_the_global_value(pickle_world, agg):
    _, blobs = pickle_world
    batches = W.sliced_batches(300, n_batches=3, seed=9) if agg else W.sliced_batches(48)
    col = pickle.loads(blobs["agg" if agg else "collection"])
    assert col._slice_shard is None
    for m in col.metrics.values():
        assert m._shard is None and m._shards == 1
        assert getattr(m, m._sliced_state_names[0]).shape[0] == col.slice_table.capacity
    got = _per_member(col.compute())
    _assert_members(got, _per_member(_feed(_unsharded(agg), batches, agg).compute()))
    _assert_members(got, _per_member(_feed(_jax(agg), batches, agg).compute()))


def test_sharded_member_unpickles_unsharded_with_the_global_value(pickle_world):
    _, blobs = pickle_world
    member = pickle.loads(blobs["member"])
    assert member._shard is None
    got = member.compute()
    want = _feed(_jax(), W.sliced_batches(48)).compute()["auroc"]
    _assert_same(_by_id(got.slice_ids, got["values"]), _by_id(want.slice_ids, want["values"]),
                 exact=True)


def test_unpickled_collection_streams_on(pickle_world):
    _, blobs = pickle_world
    col = pickle.loads(blobs["collection"])
    extra = W.sliced_batches(70, n_batches=1, seed=8)
    _feed(col, extra)
    want = _feed(_feed(_unsharded(), W.sliced_batches(48)), extra)
    _assert_members(_per_member(col.compute()), _per_member(want.compute()))


def test_pickling_leaves_the_sharded_collection_as_it_was(pickle_world):
    results, _ = pickle_world
    want = _feed(_unsharded(), W.sliced_batches(48)).compute()
    for res in results:
        got = res["after_pickling"]
        np.testing.assert_array_equal(got["ids"], want["acc"].slice_ids)
        for name in ("acc", "auroc"):
            np.testing.assert_array_equal(got[name], np.asarray(want[name]["values"], np.float64))
        for member in res["tile_rows"].values():
            assert set(v for k, v in member.items() if k != "slice_ids_hi") == {32}
        assert res["deepcopy_shares_mesh"]
