"""The port's sharded top-k forms in a real 4-process world, on gloo and the
CPU, against the JAX package.

One world is launched for the module: four processes of
``python -m torcheval_tpu_torch.utils.test_utils.sharded_worker topk``,
killed after their own timeout (120 s), each writing its results to a
JSON file. The JAX side runs in the test process: ``sharded_pallas_topk``
(interpret mode) on the first 4 of the 8 forced CPU devices for the
row-sharded form; ``jax.lax.top_k`` and the JAX package's ``topk`` over the
whole matrix for the label-sharded engine, which its module documents as
bit-identical to them (its own ``sharded_label_topk`` does not run on this
jax: shard_map's replication check refuses it); and the JAX retrieval
metrics and functionals without ``label_mesh`` on the same rows. Top-k
values are compared as int32 words and indices exactly; metric values
within rtol 1e-5 and atol 1e-8, counts exactly.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torcheval_tpu.metrics as J
from torcheval_tpu.metrics.functional import map_at_k, ndcg_at_k, recall_at_k, retrieval_hit_rate
from torcheval_tpu.ops.topk import sharded_pallas_topk
from torcheval_tpu.ops.topk import topk as jax_topk
from torcheval_tpu_torch.parallel import block_bounds
from torcheval_tpu_torch.utils.test_utils import sharded_worker as W

LAUNCH_TIMEOUT_S = 120
RTOL, ATOL = 1e-5, 1e-8
CASES = {name: (x, k, method) for name, x, k, method in W.label_cases()}


@pytest.fixture(scope="module")
def world():
    with tempfile.TemporaryDirectory(prefix="torch_sharded_topk_") as outdir:
        yield W.launch_world("topk", outdir, LAUNCH_TIMEOUT_S)


def _words(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _lax(x, k):
    v, i = jax.lax.top_k(jnp.asarray(x, jnp.float32), k)
    return _words(v), np.asarray(i)


def _assert_topk(got, x, k):
    want_v, want_i = _lax(x, k)
    np.testing.assert_array_equal(np.asarray(got["values"], np.int32), want_v)
    np.testing.assert_array_equal(np.asarray(got["indices"]), want_i)


def _concat_rows(world, key):
    return {
        "values": [row for res in world for row in res[key]["values"]],
        "indices": [row for res in world for row in res[key]["indices"]],
    }


# --------------------------------------------------------------- row-sharded
def test_row_sharded_equals_jax_sharded_pallas_topk(world):
    x = W.row_sharded_data(W.ROW_SHARDED_SHAPE)
    mesh = Mesh(np.asarray(jax.devices()[: W.WORLD]), ("data",))
    spec = NamedSharding(mesh, P("data", None))
    fn = jax.jit(lambda a: sharded_pallas_topk(a, 5, True), in_shardings=spec)
    v, i = fn(jax.device_put(jnp.asarray(x), spec))
    got = _concat_rows(world, "row")
    np.testing.assert_array_equal(np.asarray(got["values"], np.int32), _words(v))
    np.testing.assert_array_equal(np.asarray(got["indices"]), np.asarray(i))
    _assert_topk(got, x, 5)


def test_row_sharded_runs_no_collective(world):
    for res in world:
        assert res["row"]["collectives"] == [0, 0]
        assert res["row_uneven"]["collectives"] == [0, 0]


def test_row_sharded_uneven_blocks(world):
    x = W.row_sharded_data(W.ROW_SHARDED_UNEVEN)
    got = _concat_rows(world, "row_uneven")
    assert [len(res["row_uneven"]["indices"]) for res in world] == [
        b - a for a, b in (block_bounds(x.shape[0], W.WORLD, r) for r in range(W.WORLD))
    ]
    _assert_topk(got, x, 5)


def test_row_sharded_replicated_operand(world):
    x = W.row_sharded_data((16, 1536))
    for res in world:
        _assert_topk(res["row_replicated"], x, 3)


# ------------------------------------------------------------- label-sharded
@pytest.mark.parametrize("name", sorted(CASES))
def test_label_sharded_equals_lax_top_k(world, name):
    x, k, _method = CASES[name]
    for res in world:
        _assert_topk(res["label"][name], x, k)


@pytest.mark.parametrize("name", ["ties", "all_equal", "ragged_10007", "pos_inf_ties", "prune"])
def test_label_sharded_equals_jax_engine(world, name):
    x, k, method = CASES[name]
    jv, ji = jax_topk(jnp.asarray(x), k, method="dense" if method == "auto" else method)
    got = world[1]["label"][name]
    np.testing.assert_array_equal(np.asarray(got["values"], np.int32), _words(jv))
    np.testing.assert_array_equal(np.asarray(got["indices"]), np.asarray(ji))


def test_signed_zero_order_is_lax_top_k(world):
    # +0.0 before -0.0 and a real -inf before padding, on every route
    x, k, _ = CASES["signed_zeros_kernel"]
    want_v, want_i = _lax(x, k)
    assert want_i[0].tolist() == [1, 3, 8, 0, 5, 9]  # lax.top_k's order
    for name in ("signed_zeros", "signed_zeros_kernel"):
        got = world[3]["label"][name]
        np.testing.assert_array_equal(np.asarray(got["values"], np.int32), want_v)
        np.testing.assert_array_equal(np.asarray(got["indices"]), want_i)


def test_k_past_the_label_count_pads(world):
    x, k = W.k_past_labels_case()
    l = x.shape[1]
    want_v, want_i = _lax(x, l)
    for res in world:
        got = res["k_past_labels"]
        v = np.asarray(got["values"], np.int32)
        i = np.asarray(got["indices"])
        np.testing.assert_array_equal(v[:, :l], want_v)
        np.testing.assert_array_equal(i[:, :l], want_i)
        assert np.all(v[:, l:].view(np.float32) == -np.inf) and np.all(i[:, l:] == -1)


def test_gather_companion(world):
    x, t = W.pair_data()
    _, want_i = _lax(x, 3)
    for res in world:
        _assert_topk(res["gather"], x, 3)
        np.testing.assert_array_equal(
            np.asarray(res["gather"]["gathered"]), np.take_along_axis(t, want_i, axis=1)
        )


def test_label_sharded_runs_one_all_gather(world):
    assert all(res["label_collectives"] == 1 for res in world)


def test_unknown_label_axis_raises(world):
    assert all("'lable'" in res["unknown_axis"] for res in world)


# ------------------------------------------------------ retrieval, label_mesh
def _jax_metric(name, s, t, batch):
    make = {"ndcg": J.NDCG, "map": J.MAP, "recall": J.RecallAtK}[name]
    m = make(k=W.RETRIEVAL_K)
    for b in range(0, s.shape[0], batch):
        m.update(s[b : b + batch], t[b : b + batch])
    return float(m.compute()), int(np.asarray(m.num_valid))


@pytest.mark.parametrize("method", ["auto", "kernel"])
@pytest.mark.parametrize("name", ["ndcg", "map", "recall"])
def test_label_mesh_metrics_equal_the_jax_metrics(world, name, method):
    s, t = W.retrieval_data(graded=True)
    want, valid = _jax_metric(name, s, t, W.RETRIEVAL_BATCH)
    for res in world:
        got = res["metrics"][f"{name}_{method}"]
        assert got["num_valid"] == valid
        np.testing.assert_allclose(got["value"], want, rtol=RTOL, atol=ATOL)


_FUNCTIONALS = {"recall": recall_at_k, "map": map_at_k, "ndcg": ndcg_at_k,
                "hit_rate": retrieval_hit_rate}


@pytest.mark.parametrize("k", [W.RETRIEVAL_K, None, W.RETRIEVAL_L + 99])
@pytest.mark.parametrize("name", sorted(_FUNCTIONALS))
def test_label_mesh_functionals_equal_the_jax_functionals(world, name, k):
    s, t = W.retrieval_data(graded=True)
    want = np.asarray(_FUNCTIONALS[name](jnp.asarray(s), jnp.asarray(t), k=k), np.float64)
    for res in world:
        np.testing.assert_allclose(
            np.asarray(res["functional"][f"{name}_{k}"]), want, rtol=RTOL, atol=ATOL, equal_nan=True
        )


def test_bad_label_mesh_raises_at_construction(world):
    for res in world:
        nope, short, same = res["bad_label_mesh"]
        assert "'nope'" in nope and "label_mesh must be" in short and "must differ" in same


# --------------------------------------------- a 2 x 2 ("data", "label") mesh
def test_data_by_label_mesh_top_k(world):
    s, _ = W.retrieval_data(graded=False)
    for res in world:
        lo, hi = res["mesh2"]["rows"]
        _assert_topk(res["mesh2"], s[lo:hi], 7)


def test_data_by_label_mesh_syncs_over_the_data_ranks(world):
    s, t = W.retrieval_data(graded=False)
    want, valid = _jax_metric("recall", s, t, W.RETRIEVAL_BATCH // 2)
    for res in world:
        got = res["mesh2"]
        lo, hi = got["rows"]
        local, _ = _jax_metric("recall", s[lo:hi], t[lo:hi], W.RETRIEVAL_BATCH // 2)
        np.testing.assert_allclose(got["local"], local, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["synced"], want, rtol=RTOL, atol=ATOL)
        assert got["num_valid_data_sync"] == valid
        # the label ranks hold the same state: a sync over every rank counts
        # each row once per label rank
        assert got["num_valid_world_sync"] == 2 * valid
        assert len(got["data_ranks"]) == 2
