"""The port's float-prefix buckets (``torcheval_tpu_torch/sketch/buckets.py``)
against the JAX package's, on the CPU.

Mirrors ``tests/sketch/test_buckets.py``. The same seeded numpy values go
through both packages: order keys, bucket ids, edges and representatives
must be bit-equal, special values included (+-0, +-subnormals, +-tiny,
+-inf, NaN, the largest finite magnitudes, bfloat16 and float16 inputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu import sketch as J
from torcheval_tpu_torch import sketch as T
from torcheval_tpu_torch.sketch import buckets as TB

TINY = np.finfo(np.float32).tiny
SPECIAL = np.float32(
    [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 3.4e38, -3.4e38, TINY, -TINY,
     1e-40, -1e-40, 1e-45, -1e-45, np.nextafter(TINY, 0), -np.nextafter(TINY, 0),
     0.25, -0.25, 1.0, -1.0, 0.5, 0.999999, 1e30, -1e30, 1e-30, -1e-30]
)


def _values(seed=42, n=4000):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        (rng.normal(size=n) * 10).astype(np.float32),
        rng.lognormal(0, 6, n).astype(np.float32),
        -rng.lognormal(0, 6, n).astype(np.float32),
        np.repeat(np.float32([0.25, -0.25, 1e30, 1e-30]), 50),
        SPECIAL,
    ])


@pytest.mark.parametrize("bits", [4, 10, 12, 14, 16, 20])
def test_bucket_ids_bit_equal(bits):
    x = _values()
    want = np.asarray(J.bucket_index(jnp.asarray(x), bits))
    got = T.bucket_index(torch.from_numpy(x), bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_order_key_bit_equal_monotone_and_zero_canonical():
    x = _values()
    want = np.asarray(J.ascending_key(jnp.asarray(x))).astype(np.int64)
    got = T.ascending_key(torch.from_numpy(x))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    finite = np.sort(x[~np.isnan(x)])
    keys = T.ascending_key(torch.from_numpy(finite)).numpy()
    assert (np.diff(keys) >= 0).all()
    z = T.ascending_key(torch.tensor([0.0, -0.0, 1e-40, -1e-40])).numpy()
    assert (z == z[0]).all()
    assert T.ascending_key(torch.tensor([float("nan")])).item() == 0xFFFFFFFF


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_inputs_bit_equal(dtype):
    # half values widen to float32 exactly in both packages; float16
    # subnormals are float32 normals and keep their own buckets
    x = torch.from_numpy(_values(seed=3, n=500)).to(dtype)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    xj = jnp.asarray(x.to(torch.float32).numpy()).astype(jd)
    for bits in (10, 16):
        np.testing.assert_array_equal(
            T.bucket_index(x, bits).numpy(), np.asarray(J.bucket_index(xj, bits))
        )


@pytest.mark.parametrize("bits", [10, 12, 16, 20])
def test_edges_and_representatives_bit_equal(bits):
    for got, want in zip(T.bucket_edges(bits), J.bucket_edges(bits)):
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(
        T.bucket_representatives(bits).view(np.int32),
        J.bucket_representatives(bits).view(np.int32),
    )


def test_every_value_within_its_bucket_edges_and_relative_error():
    x = _values()
    x = x[~np.isnan(x)]
    normal = np.isfinite(x) & (np.abs(x) >= TINY)
    for bits in (10, 14, 16, 20):
        idx = T.bucket_index(torch.from_numpy(x), bits).numpy()
        lo, hi = T.bucket_edges(bits)
        sub = np.abs(x) < TINY  # flushed to the zero bucket
        assert ((lo[idx] <= x) | sub).all() and ((x <= hi[idx]) | sub).all()
        reps = T.bucket_representatives(bits)[idx[normal]]
        rel = np.abs(reps - x[normal]) / np.abs(x[normal])
        assert rel.max() <= T.relative_error(bits)
        assert T.relative_error(bits) == J.relative_error(bits)


def test_inf_buckets_keep_infinite_representatives():
    idx = T.bucket_index(torch.tensor([float("inf"), float("-inf")]), 12).numpy()
    reps = T.bucket_representatives(12)
    assert reps[idx[0]] == np.inf and reps[idx[1]] == -np.inf


def test_bucket_index_under_vmap_equals_eager():
    x = torch.from_numpy(_values()[:2000].copy())
    eager = T.bucket_index(x, 14)
    mapped = torch.func.vmap(lambda v: T.bucket_index(v, 14))(x.reshape(50, -1)).reshape(-1)
    assert torch.equal(eager, mapped)


@pytest.mark.parametrize("bad", [9, 21, 0, -3, 2.5])
def test_bucket_bits_validation(bad):
    with pytest.raises(ValueError):
        T.check_bucket_bits(bad)
    with pytest.raises(ValueError):
        J.check_bucket_bits(bad)


def test_constants_match():
    for name in ("DEFAULT_BUCKET_BITS", "DEFAULT_MC_BUCKET_BITS", "MIN_BUCKET_BITS",
                 "MAX_BUCKET_BITS", "SKETCH_FOLD_ROWS"):
        assert getattr(T, name) == getattr(J, name), name
    assert sorted(T.__all__) == sorted(J.__all__)


def test_resolve_approx_knob(monkeypatch):
    monkeypatch.delenv("TORCHEVAL_TPU_APPROX", raising=False)
    for fn in (T.resolve_approx, J.resolve_approx):
        assert fn(None) is None
        assert fn(False) is None
        assert fn(True, default_bits=14) == 14
        assert fn(4096) == 12
        for bad in (1000, 2):
            with pytest.raises(ValueError):
                fn(bad)
    for env, default, want in (("1", 13, 13), ("on", 16, 16), ("8192", 16, 13), ("0", 16, None),
                               ("off", 16, None)):
        monkeypatch.setenv("TORCHEVAL_TPU_APPROX", env)
        assert T.resolve_approx(None, default_bits=default) == want
        assert J.resolve_approx(None, default_bits=default) == want
        assert T.resolve_approx(False) is None  # an explicit opt-out wins
    monkeypatch.setenv("TORCHEVAL_TPU_APPROX", "bogus")
    with pytest.raises(ValueError):
        T.resolve_approx(None)


def test_representatives_on_is_cached_per_device_and_order():
    a = TB.representatives_on(12, "cpu")
    assert a is TB.representatives_on(12, torch.device("cpu"))
    d = TB.representatives_on(12, "cpu", descending=True)
    np.testing.assert_array_equal(d.numpy(), T.bucket_representatives(12)[::-1])
    np.testing.assert_array_equal(a.numpy(), T.bucket_representatives(12))
