"""The port's wire codecs (``torcheval_tpu_torch/utils/quant.py``) against the
JAX package's (``torcheval_tpu/utils/quant.py``), byte for byte, on the CPU.

For every codec and a spread of numpy inputs made from a seed, each
package's encoding must equal the other's, and each package must decode
the other's bytes to the same array (exactly; q8 to the same float32
dequantization). The ``TORCHEVAL_TPU_SYNC_QUANTIZE`` knob must accept and
refuse the same values, with the same errors.
"""

import numpy as np
import pytest

from torcheval_tpu.utils import quant as JQ
from torcheval_tpu_torch.utils import quant as TQ

rng = np.random.default_rng(12)


def _ints(dtype, n, lo, hi, sparse=False):
    a = rng.integers(lo, hi, n).astype(dtype)
    if sparse:
        a[rng.random(n) < 0.97] = 0
    return a


INT_CASES = {
    "i32_small_span": _ints(np.int32, 1000, 0, 200),
    "i32_u16_span": _ints(np.int32, 777, -30000, 30000),
    "i64_counts": _ints(np.int64, 4096, 0, 50),
    "i64_wide_span": _ints(np.int64, 300, -(2**40), 2**40),
    "u32": _ints(np.uint32, 513, 0, 70000),
    "i16": _ints(np.int16, 400, 0, 100),
    "u8": _ints(np.uint8, 100, 0, 255),
    "i32_sparse": _ints(np.int32, 1 << 16, 1, 9, sparse=True),
    "i32_all_zero": np.zeros(5000, np.int32),
    "i32_2d": _ints(np.int32, 64 * 50, 0, 1000).reshape(64, 50),
    "i32_scalar": np.asarray(7, np.int32),
    "i32_empty": np.zeros(0, np.int32),
    "i64_sorted": np.sort(_ints(np.int64, 2000, 0, 10**9)),
}
FLOAT_CASES = {
    "f32_uniform": rng.random(1000).astype(np.float32) * 10,
    "f32_normal_2d": rng.standard_normal((33, 77)).astype(np.float32),
    "f32_ragged_block": rng.standard_normal(257).astype(np.float32),
    "f32_zero_block": np.concatenate([np.zeros(256, np.float32), rng.random(300).astype(np.float32)]),
    "f32_small": rng.random(63).astype(np.float32),
    "f32_nan": np.where(rng.random(500) < 0.01, np.nan, rng.random(500)).astype(np.float32),
    "f32_inf": np.where(rng.random(500) < 0.01, np.inf, rng.random(500)).astype(np.float32),
    "f64": rng.random(500),
}


def _both_ways(encode, decode, arr, *decode_args):
    j, t = getattr(JQ, encode)(arr), getattr(TQ, encode)(arr)
    assert j == t  # bytes for bytes, or both None
    if j is None:
        return None
    dj = getattr(JQ, decode)(t, *decode_args)  # JAX reads the port's bytes
    dt = getattr(TQ, decode)(j, *decode_args)  # and the port the JAX package's
    assert dj.dtype == dt.dtype and dj.shape == dt.shape
    np.testing.assert_array_equal(dj, dt)
    return dt


@pytest.mark.parametrize("name", sorted(INT_CASES))
def test_narrow_int_both_ways(name):
    a = INT_CASES[name]
    got = _both_ways("narrow_int_encode", "narrow_int_decode", a, a.dtype, a.shape)
    if got is not None:
        np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("name", sorted(INT_CASES))
def test_delta_int_both_ways(name):
    a = INT_CASES[name]
    got = _both_ways("delta_int_encode", "delta_int_decode", a, a.dtype, a.shape)
    if got is not None:
        np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("name", sorted(INT_CASES))
def test_bucket_payload_both_ways(name):
    a = INT_CASES[name]
    got = _both_ways("bucket_payload_encode", "bucket_payload_decode", a, a.dtype, a.shape)
    if got is not None:
        np.testing.assert_array_equal(got, a)


def test_the_sparse_and_narrow_cases_do_encode():
    # the byte-for-byte checks above are not all None == None
    assert TQ.bucket_payload_encode(INT_CASES["i32_sparse"]) is not None
    assert TQ.narrow_int_encode(INT_CASES["i64_counts"]) is not None
    assert TQ.delta_int_encode(INT_CASES["i64_sorted"]) is not None
    assert TQ.q8_encode(FLOAT_CASES["f32_uniform"]) is not None


@pytest.mark.parametrize("name", sorted(FLOAT_CASES))
def test_q8_both_ways_and_within_its_bound(name):
    a = FLOAT_CASES[name]
    got = _both_ways("q8_encode", "q8_decode", a, a.shape)
    if got is None:
        assert a.dtype != np.float32 or a.size < TQ.Q8_MIN_ELEMENTS or not np.isfinite(a).all()
        return
    flat = a.reshape(-1).astype(np.float64)
    pad = -flat.size % TQ.Q8_BLOCK
    blocks = np.abs(np.concatenate([flat, np.zeros(pad)])).reshape(-1, TQ.Q8_BLOCK).max(axis=1)
    bound = np.repeat(blocks / 254.0, TQ.Q8_BLOCK)[: flat.size]
    err = np.abs(got.reshape(-1).astype(np.float64) - flat)
    assert np.all(err <= bound * (1 + 1e-6) + 1e-30)


@pytest.mark.parametrize("name", ["f32_uniform", "f32_normal_2d", "f32_zero_block"])
def test_q8_parts_round_trip_both_ways(name):
    a = FLOAT_CASES[name]
    (js, jq), (ts, tq) = JQ.q8_parts(a), TQ.q8_parts(a)
    np.testing.assert_array_equal(js, ts)
    np.testing.assert_array_equal(jq, tq)
    np.testing.assert_array_equal(JQ.q8_from_parts(ts, tq, a.shape), TQ.q8_from_parts(js, jq, a.shape))


def test_constants_match():
    assert (TQ.Q8_BLOCK, TQ.Q8_MIN_ELEMENTS) == (JQ.Q8_BLOCK, JQ.Q8_MIN_ELEMENTS) == (256, 64)
    assert TQ._BUCKET_HEAD.format == JQ._BUCKET_HEAD.format == "<IBBI"
    assert TQ._NARROW_HEAD.format == JQ._NARROW_HEAD.format


ENV_VALUES = ["0", "", "false", "OFF", "1", "true", "On", "bf16", "BF16", "int8", " Int8 "]


@pytest.mark.parametrize("value", ENV_VALUES)
def test_env_knob_accepts_what_the_jax_package_accepts(monkeypatch, value):
    monkeypatch.setenv("TORCHEVAL_TPU_SYNC_QUANTIZE", value)
    assert TQ.sync_quantize_mode() == JQ.sync_quantize_mode()
    assert TQ.sync_quantize_enabled() == JQ.sync_quantize_enabled()
    assert TQ.sync_quantize_enabled(False) is False and TQ.sync_quantize_enabled(True) is True


def test_env_knob_unset_is_off(monkeypatch):
    monkeypatch.delenv("TORCHEVAL_TPU_SYNC_QUANTIZE", raising=False)
    assert TQ.sync_quantize_mode() is False is JQ.sync_quantize_mode()


@pytest.mark.parametrize("value", ["2", "yes", "in8t", "fp8"])
def test_env_knob_refuses_what_the_jax_package_refuses(monkeypatch, value):
    monkeypatch.setenv("TORCHEVAL_TPU_SYNC_QUANTIZE", value)
    with pytest.raises(ValueError) as jax_err:
        JQ.sync_quantize_mode()
    with pytest.raises(ValueError) as port_err:
        TQ.sync_quantize_mode()
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError):
        TQ.sync_quantize_enabled()


@pytest.mark.parametrize("override,want", [(True, "bf16"), (False, False), ("bf16", "bf16"),
                                           ("INT8", "int8"), (" int8", "int8")])
def test_per_call_modes(monkeypatch, override, want):
    monkeypatch.setenv("TORCHEVAL_TPU_SYNC_QUANTIZE", "int8")
    assert TQ.sync_quantize_mode(override) == want == JQ.sync_quantize_mode(override)


@pytest.mark.parametrize("override", ["in8t", "fp16", ""])
def test_per_call_typos_raise_like_jax(override):
    with pytest.raises(ValueError) as jax_err:
        JQ.sync_quantize_mode(override)
    with pytest.raises(ValueError) as port_err:
        TQ.sync_quantize_mode(override)
    assert str(port_err.value) == str(jax_err.value)
