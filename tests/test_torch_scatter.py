"""The port's segment scatter against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through
``torcheval_tpu.ops.scatter`` (``segment_scatter`` on its XLA route and
``pallas_segment_sum`` in interpret mode, the Pallas kernel run as the JAX
package's own tests run it) and ``torcheval_tpu_torch.ops.scatter`` (on CPU
tensors, where ``segment_sum`` runs its plain version). Integers and
integer-valued floats must match exactly. Float sums may differ by the
order of their adds: each side is within ``(count - 1) * 2^-24 * sum|v|``
of the exact sum per segment and lane (the module's stated bound), so the
two are held within twice that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.ops.scatter import pallas_segment_sum
from torcheval_tpu.ops.scatter import segment_scatter as jax_segment_scatter
from torcheval_tpu_torch.ops.scatter import (
    segment_scatter,
    segment_sum,
    segment_sum_plain,
)

_JAX_OPS = {
    "sum": jax.ops.segment_sum,
    "max": jax.ops.segment_max,
    "min": jax.ops.segment_min,
}


def _rows(rng, n, s):
    return rng.integers(-2, s + 3, n)  # out of range on both sides


def _ref_sum(vals, rows, s):
    out = np.zeros((s,) + vals.shape[1:], np.float64)
    for r, v in zip(rows, vals):
        if 0 <= r < s:
            out[r] += v
    return out


@pytest.mark.parametrize(
    "n,d,s",
    [(211, 3, 7), (1024, 128, 64), (37, 1, 513), (8, 130, 9), (300, 1, 1), (500, 3, 12_288)],
)
def test_sum_matches_pallas_interpret_and_xla(n, d, s):
    rng = np.random.default_rng(n + d + s)
    vals = rng.integers(0, 5, (n, d)).astype(np.float32)  # sums are exact in float32
    rows = _rows(rng, n, s)
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(rows), s).numpy()
    pallas = np.asarray(pallas_segment_sum(jnp.asarray(vals), jnp.asarray(rows), s, interpret=True))
    xla = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(rows), num_segments=s))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, _ref_sum(vals, rows, s))


@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
@pytest.mark.parametrize("d", [1, 3, 130])
def test_reduces_match_xla(reduce, dtype, d):
    rng = np.random.default_rng(d)
    n, s = 400, 37
    if np.issubdtype(dtype, np.integer):
        vals = rng.integers(-1000, 1000, (n, d)).astype(dtype)
    else:
        vals = rng.standard_normal((n, d)).astype(dtype)
    rows = _rows(rng, n, s)
    got = segment_scatter(torch.from_numpy(vals), torch.from_numpy(rows), s, reduce=reduce).numpy()
    # JAX runs 32-bit: an int64 column arrives as int32, with the same values
    want = np.asarray(
        jax_segment_scatter(jnp.asarray(vals), jnp.asarray(rows), s, reduce=reduce, method="xla")
    )
    assert got.dtype == dtype and got.shape == (s, d)
    if reduce != "sum" or not np.issubdtype(dtype, np.floating):
        np.testing.assert_array_equal(got, want)
        return
    count = np.bincount(rows[(rows >= 0) & (rows < s)], minlength=s)[:, None]
    mag = _ref_sum(np.abs(vals.astype(np.float64)), rows, s)
    bound = 2 * np.maximum(count - 1, 0) * 2.0**-24 * mag
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)
    assert np.all(np.abs(got.astype(np.float64) - _ref_sum(vals, rows, s)) <= bound / 2)


def test_nd_tail_and_int64_rows():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 9, (128, 3, 4)).astype(np.int32)
    rows = rng.integers(0, 11, 128)
    got = segment_scatter(torch.from_numpy(vals), torch.from_numpy(rows), 11)
    want = jax_segment_scatter(jnp.asarray(vals), jnp.asarray(rows), 11, method="pallas")
    assert got.dtype == torch.int32 and got.shape == (11, 3, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # int32 and int64 row columns give the same answer
    got32 = segment_scatter(torch.from_numpy(vals), torch.from_numpy(rows).int(), 11)
    assert torch.equal(got, got32)


@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
def test_empty_stream(reduce):
    got = segment_scatter(torch.zeros((0, 4)), torch.zeros(0, dtype=torch.int32), 6, reduce=reduce)
    want = jax_segment_scatter(jnp.zeros((0, 4)), jnp.zeros((0,), jnp.int32), 6, reduce=reduce)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if reduce == "sum":
        pallas = pallas_segment_sum(
            jnp.zeros((0, 4), jnp.float32), jnp.zeros((0,), jnp.int32), 6, interpret=True
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
def test_nan_and_inf_propagate_as_in_jax(reduce):
    rng = np.random.default_rng(11)
    vals = rng.standard_normal((60, 2)).astype(np.float32)
    vals[3, 0] = np.nan
    vals[7, 1] = np.inf
    vals[9, 1] = -np.inf
    rows = rng.integers(0, 5, 60)
    got = segment_scatter(torch.from_numpy(vals), torch.from_numpy(rows), 5, reduce=reduce).numpy()
    want = np.asarray(_JAX_OPS[reduce](jnp.asarray(vals), jnp.asarray(rows), num_segments=5))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-6)


def test_methods_and_plain_version_agree_on_the_cpu():
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(rng.integers(-50, 50, (300, 2)).astype(np.int64))
    rows = torch.from_numpy(rng.integers(-1, 40, 300))
    want = segment_sum_plain(vals, rows, 40)
    for method in ("auto", "kernel", "torch"):
        assert torch.equal(segment_scatter(vals, rows, 40, method=method), want)
    before = segment_sum.launches
    segment_sum(vals, rows, 40)
    assert segment_sum.launches == before  # the plain version launches nothing


def test_validation_errors():
    v = torch.zeros((4, 2))
    r = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="reduce must be"):
        segment_scatter(v, r, 3, reduce="mean")
    with pytest.raises(ValueError, match="method must be"):
        segment_scatter(v, r, 3, method="pallas")
    with pytest.raises(ValueError, match="sum.*only"):
        segment_scatter(v, r, 3, reduce="max", method="kernel")
    with pytest.raises(ValueError, match=r"vals \(N, \.\.\.\)"):
        segment_sum(torch.zeros((5, 2)), r, 3)
    with pytest.raises(TypeError, match="rows must be"):
        segment_sum(v, r.float(), 3)
    for bad in (torch.bool, torch.uint8, torch.int16):
        with pytest.raises(TypeError, match="int32, int64, float32, float64, bfloat16 or float16"):
            segment_sum(v.to(bad), r, 3)
    # half precision adds in its own type on the CPU (the JAX package's XLA route)
    assert segment_sum(v.to(torch.float16) + 1, r, 3).dtype == torch.float16
