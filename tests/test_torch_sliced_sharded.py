"""The port's slice-sharded ``SlicedMetricCollection`` in a real 4-process
world, on gloo and the CPU, against the JAX package's sharded collection.

Mirrors ``tests/metrics/test_sliced_sharded.py`` with one world for the
module: four processes of ``python -m
torcheval_tpu_torch.utils.test_utils.sharded_worker sliced``, killed after
their own timeout (120 s). Before the launch the test writes a JAX
collection's state dicts (capacity 7, not a multiple of the 4 ranks) for
the workers to load; rank 0 writes the port's state dicts back, which the
test loads into the JAX package's collections, sharded over the first 4 of
the 8 forced CPU devices and unsharded. Ids and counts compare exactly, and
so do accuracy, AUROC and max values (the same counts through the same
math); means within rtol 1e-5.
"""

import os
import tempfile

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import torcheval_tpu.metrics as J
from torcheval_tpu_torch.utils.test_utils import sharded_worker as W

LAUNCH_TIMEOUT_S = 120
RTOL = 1e-5
JAX_STATE_CAPACITY, JAX_STATE_COHORTS = 7, 6


def _jax_col(sharded: bool, capacity: int = 8, agg: bool = False):
    members = ({"mean": J.Mean(), "max": J.Max()} if agg else
               {"acc": J.BinaryAccuracy(), "auroc": J.BinaryAUROC(approx=1024)})
    kw = {}
    if sharded:
        kw = {"mesh": Mesh(np.asarray(jax.devices()[: W.WORLD]), ("slices",)), "mesh_axis": "slices"}
    return J.SlicedMetricCollection(members, capacity=capacity, **kw)


def _jax_feed(col, batches, agg=False):
    for ids, s, t in batches:
        if agg:
            col.update(ids, s)
        else:
            col.update(ids, s, t)
    return col


def _jax_values(col) -> dict:
    out = col.compute()
    first = next(iter(out.values()))
    res = {"ids": np.asarray(first.slice_ids).tolist()}
    for name, r in out.items():
        res[name] = np.asarray(r["values"], np.float64).tolist()
    return res


def _assert_values(got, want):
    np.testing.assert_array_equal(np.asarray(got["ids"]), np.asarray(want["ids"]))
    for name in want:
        if name == "ids":
            continue
        if name == "mean":
            np.testing.assert_allclose(got[name], want[name], rtol=RTOL)
        else:
            np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]))


def _save_jax_state(path):
    col = _jax_feed(_jax_col(False, JAX_STATE_CAPACITY), W.sliced_batches(JAX_STATE_COHORTS))
    flat = {f"{m}/{k}": np.asarray(v) for m, sd in col.state_dicts().items() for k, v in sd.items()}
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def world():
    with tempfile.TemporaryDirectory(prefix="torch_sliced_sharded_") as outdir:
        _save_jax_state(os.path.join(outdir, "jax_state.npz"))
        results = W.launch_world("sliced", outdir, LAUNCH_TIMEOUT_S)
        states = {name: W.load_states(os.path.join(outdir, f"{name}.npz"))
                  for name in ("port_state", "port_state_streamed")}
        yield results, states


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("sharded", [True, False])
def test_parity_small_capacity(world, sharded):
    want = _jax_values(_jax_feed(_jax_col(sharded), W.sliced_batches(8)))
    for res in world[0]:
        _assert_values(res["small"], want)
        assert res["small"]["capacity"] == 8


def test_parity_with_growth_past_2048(world):
    jcol = _jax_feed(_jax_col(True, 2048), W.sliced_batches(2500))
    want = _jax_values(jcol)
    for res in world[0]:
        _assert_values(res["growth"], want)
        assert res["growth"]["capacity"] == jcol.slice_table.capacity
        assert res["growth"]["capacity"] >= 2560 and res["growth"]["capacity"] % W.WORLD == 0


def test_states_are_tiles_and_id_lanes_are_replicated(world):
    for res in world[0]:
        for member in res["tile_rows"].values():
            assert member.pop("slice_ids_hi") == 64
            assert set(member.values()) == {64 // W.WORLD}


def test_capacity_rounds_up_to_the_shard_multiple(world):
    assert _jax_col(True, 3).slice_table.capacity == W.WORLD
    assert all(res["capacity_rounded"] == W.WORLD for res in world[0])


def test_validation(world):
    for res in world[0]:
        no_axis, bad_axis, no_mesh = res["validation"]
        assert "mesh_axis" in no_axis and "'nope'" in bad_axis and "requires mesh" in no_mesh


def test_explicit_mesh_dim(world):
    want = _jax_values(_jax_feed(_jax_col(False), W.sliced_batches(8, n_batches=1)))
    for res in world[0]:
        _assert_values(res["explicit_mesh"], want)


# -------------------------------------------------- merge, reset and copies
@pytest.mark.parametrize("source", ["merge", "merge_plain_source"])
def test_merge_collections_parity(world, source):
    want = _jax_values(_jax_feed(_jax_col(False), W.sliced_batches(40, n_batches=4)))
    for res in world[0]:
        _assert_values(res[source], want)


def test_reset_then_reuse_parity(world):
    want = _jax_values(_jax_feed(_jax_col(False), W.sliced_batches(24)))
    for res in world[0]:
        _assert_values(res["reset"], want)


def test_deepcopy_keeps_sharding_and_parity(world):
    for res in world[0]:
        _assert_values(res["deepcopy"], res["deepcopy_before"])
        assert res["deepcopy_shares_mesh"]
        rows = res["deepcopy_tile_rows"]["auroc"]
        assert rows["sketch_tp"] * W.WORLD == rows["slice_ids_hi"]


def test_update_placed_equals_update(world):
    want = _jax_values(_jax_feed(_jax_col(True), W.sliced_batches(24)))
    for res in world[0]:
        _assert_values(res["update_placed"], want)


def test_mean_and_max_members_on_tiles(world):
    batches = W.sliced_batches(300, n_batches=3, seed=9)
    want = _jax_values(_jax_feed(_jax_col(True, 64, agg=True), batches, agg=True))
    for res in world[0]:
        _assert_values(res["agg_sharded"], want)
        _assert_values(res["agg_plain"], want)


# ------------------------------------------------------------- state dicts
def test_state_dicts_cross_load_within_the_port(world):
    want = _jax_values(_jax_feed(_jax_col(False), W.sliced_batches(24)))
    for res in world[0]:
        _assert_values(res["to_plain"], want)
        _assert_values(res["back_to_sharded"], want)
        rows = res["back_tile_rows"]["acc"]
        assert rows["num_correct"] * W.WORLD == rows["slice_ids_hi"]


@pytest.mark.parametrize("sharded", [True, False])
def test_port_state_loads_into_the_jax_collection(world, sharded):
    want = _jax_values(_jax_feed(_jax_col(False), W.sliced_batches(24)))
    jcol = _jax_col(sharded)
    jcol.load_state_dicts(world[1]["port_state"])
    _assert_values(_jax_values(jcol), want)


def test_jax_state_loads_into_the_sharded_port(world):
    want = _jax_values(_jax_feed(_jax_col(False, JAX_STATE_CAPACITY), W.sliced_batches(JAX_STATE_COHORTS)))
    for res in world[0]:
        _assert_values(res["from_jax"], want)
        # capacity 7 pads up to the shard multiple
        assert res["from_jax_capacity"] == 8


@pytest.mark.parametrize("sharded", [True, False])
def test_streamed_state_goes_back_to_jax(world, sharded):
    jcol = _jax_feed(_jax_col(False, JAX_STATE_CAPACITY), W.sliced_batches(JAX_STATE_COHORTS))
    _jax_feed(jcol, W.sliced_batches(30, n_batches=1, seed=8))
    want = _jax_values(jcol)
    for res in world[0]:
        _assert_values(res["from_jax_streamed"], want)
    back = _jax_col(sharded)
    back.load_state_dicts(world[1]["port_state_streamed"])
    _assert_values(_jax_values(back), want)


def test_sketch_extent_bound_is_per_shard(world):
    for res in world[0]:
        plain, sharded, past = res["extent"]
        assert "int32 segment-index" in plain
        assert sharded == ""
        assert "over 4 shard" in past
