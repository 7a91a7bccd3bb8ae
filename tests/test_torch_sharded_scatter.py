"""The port's sharded segment sums in a real 4-process world, on gloo and
the CPU, against the JAX package.

One world is launched for the module: four processes of
``python -m torcheval_tpu_torch.utils.test_utils.sharded_worker scatter``,
killed after their own timeout (120 s). The references run in the test
process on the first 4 of the 8 forced CPU devices: the JAX package's
``segment_scatter(mesh=, axis=)`` (its block-range route) for the ranks'
tiles, ``sharded_pallas_segment_sum(interpret=True)`` over the ranks'
samples sharded along the sample axis, and ``sliced_score_hist_fold(...,
shard=)`` for the sketch fold's tiles. Integers compare exactly, floats
within rtol 1e-5 and atol 1e-8 (the plain version adds in another order
than XLA's scatter).
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from torcheval_tpu.ops.scatter import segment_scatter, sharded_pallas_segment_sum
from torcheval_tpu.sketch.cache import sliced_score_hist_fold
from torcheval_tpu_torch.sketch.cache import check_sliced_sketch_extent
from torcheval_tpu_torch.utils.test_utils import sharded_worker as W

LAUNCH_TIMEOUT_S = 120
RTOL, ATOL = 1e-5, 1e-8
CASES = {name: (vals, rows, reduce) for name, vals, rows, reduce, _ in W.scatter_cases()}


@pytest.fixture(scope="module")
def world():
    with tempfile.TemporaryDirectory(prefix="torch_sharded_scatter_") as outdir:
        yield W.launch_world("scatter", outdir, LAUNCH_TIMEOUT_S)


def _mesh():
    return Mesh(np.asarray(jax.devices()[: W.WORLD]), ("slices",))


def _assert_equal(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if np.issubdtype(dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiles_equal_the_jax_mesh_route(world, name):
    vals, rows, reduce = CASES[name]
    want = segment_scatter(jnp.asarray(vals), jnp.asarray(rows), W.SCATTER_SEGMENTS,
                           reduce=reduce, mesh=_mesh(), axis="slices")
    w = W.SCATTER_SEGMENTS // W.WORLD
    for r, res in enumerate(world):
        tile = res["tiles"][name]
        assert tile["shape"] == [w] + list(vals.shape[1:])
        assert tile["dtype"] == f"torch.{vals.dtype}"
        _assert_equal(tile["values"], np.asarray(want)[r * w : (r + 1) * w], vals.dtype)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tiles_equal_the_unsharded_reduction(world, name):
    vals, rows, reduce = CASES[name]
    want = segment_scatter(jnp.asarray(vals), jnp.asarray(rows), W.SCATTER_SEGMENTS, reduce=reduce)
    got = np.concatenate([np.asarray(res["tiles"][name]["values"]) for res in world])
    _assert_equal(got, want, vals.dtype)


def test_mesh_route_runs_no_collective(world):
    for res in world:
        assert all(t["collectives"] == [0, 0] for t in res["tiles"].values())


def test_uneven_extent_and_unpaired_mesh_raise(world):
    for res in world:
        assert "not a multiple" in res["uneven"]
        assert "passed together" in res["mesh_without_axis"]


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_sharded_segment_sum_equals_sharded_pallas_segment_sum(world, dtype):
    parts = [W.sharded_sum_shard(r, dtype) for r in range(W.WORLD)]
    vals = np.concatenate([p[0] for p in parts])
    rows = np.concatenate([p[1] for p in parts]).astype(np.int32)
    mesh = _mesh()
    vs = jax.device_put(jnp.asarray(vals), NamedSharding(mesh, P("slices", None)))
    rs = jax.device_put(jnp.asarray(rows), NamedSharding(mesh, P("slices")))
    fn = jax.jit(lambda v, r: sharded_pallas_segment_sum(v, r, W.SHARDED_SUM_SEGMENTS, True))
    want = np.asarray(fn(vs, rs))
    for res in world:
        got = res["sharded_sum"][dtype]
        assert got["dtype"] == f"torch.{dtype}"
        _assert_equal(got["values"], want, np.dtype(dtype))


def test_sharded_sketch_fold_equals_the_jax_shard_branch(world):
    rows, scores, targets = W.sketch_fold_data()
    want = sliced_score_hist_fold(jnp.asarray(rows), jnp.asarray(scores), jnp.asarray(targets),
                                  W.SKETCH_BITS, W.SKETCH_SLICES, shard=(_mesh(), "slices"))
    w = W.SKETCH_SLICES // W.WORLD
    for name, value in want.items():
        got = np.concatenate([np.asarray(res["sketch_fold"][name]) for res in world])
        np.testing.assert_array_equal(got, np.asarray(value))
        assert all(len(res["sketch_fold"][name]) == w for res in world)
    assert int(np.asarray(want["sketch_nan_dropped"]).sum()) == int(np.isnan(scores).sum())


@pytest.mark.parametrize("bits", [4, 10, 16])
def test_sketch_extent_bound_is_per_shard(bits):
    # the same width is rejected over one shard and accepted over two
    planes = 2 * (1 << bits) + 1
    per_shard = (2**31 - 1) // planes
    with pytest.raises(ValueError, match="int32 segment-index"):
        check_sliced_sketch_extent(bits, 2 * per_shard)
    check_sliced_sketch_extent(bits, 2 * per_shard, shards=2)
    with pytest.raises(ValueError, match="over 2 shard"):
        check_sliced_sketch_extent(bits, 2 * per_shard + 1, shards=2)
