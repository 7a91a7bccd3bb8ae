"""The port's top-k engine against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through ``jax.lax.top_k`` (and
the JAX package's ``pallas_topk`` in interpret mode, and its ``prune_topk``)
and through ``torcheval_tpu_torch.ops.topk``, where ``method="kernel"`` on a
CPU tensor runs the kernel's plain version. Tolerance: none. Values are
compared bit for bit (as int32 words, so -0.0 differs from +0.0 and NaN
payloads count) and indices exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.ops.topk import pallas_topk as jax_pallas_topk
from torcheval_tpu.ops.topk import prune_topk as jax_prune_topk
from torcheval_tpu_torch.ops.topk import (
    _DENSE_L_MAX,
    _KERNEL_MAX_K,
    _flip,
    _pick_method,
    order_key,
    prune_topk,
    topk,
    topk_indices,
    topk_kernel,
    topk_kernel_plain,
    topk_values,
)

CPU = torch.device("cpu")
CUDA = torch.device("cuda", 0)  # only compared, never allocated on


def _bits(v):
    return np.asarray(v, dtype=np.float32).view(np.int32)


def _assert_same(got, want_v, want_i):
    v, i = got
    assert i.dtype == torch.int64
    np.testing.assert_array_equal(_bits(v.numpy()), _bits(want_v))
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))


def _lax(x, k):
    v, i = jax.lax.top_k(jnp.asarray(x), k)
    return np.asarray(v), np.asarray(i)


def _case(name, rng):
    """(16, 1300) rows of one kind; 1300 is past the dense threshold and not
    a multiple of any tile."""
    n, l = 16, 1300
    if name == "random":
        return rng.random((n, l), dtype=np.float32)
    if name == "ties":
        return rng.integers(0, 5, (n, l)).astype(np.float32)
    if name == "all_equal":
        return np.full((n, l), 0.25, np.float32)
    x = rng.integers(-2, 3, (n, l)).astype(np.float32)
    if name == "inf":
        x[:, ::7] = np.inf
        x[:, 3::11] = -np.inf
        x[-1] = -np.inf
        x[-1, 700] = 1.0
    elif name == "signed_zero":
        x[:, ::3] = -0.0
        x[:, 1::3] = 0.0
        x[0, :4] = [-0.0, 0.0, -1.0, 0.0]
    elif name == "nan":
        x[:, ::5] = np.nan
        x[:, 2::9] = -np.nan
        x[:, 4::13] = -0.0
        x[:, 6::17] = np.inf
        x[1] = np.nan
    return x


CASES = ["random", "ties", "all_equal", "inf", "signed_zero", "nan"]


@pytest.mark.parametrize("method", ["dense", "kernel"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", [1, 5, 128])
def test_matches_lax_top_k_bit_for_bit(method, case, k):
    x = _case(case, np.random.default_rng(k))
    _assert_same(topk(torch.from_numpy(x), k, method=method), *_lax(x, k))


@pytest.mark.parametrize("method", ["dense", "kernel"])
@pytest.mark.parametrize("l", [1, 7, 100, 1025])
def test_k_equals_l_and_ragged_widths(method, l):
    x = _case("nan", np.random.default_rng(l))[:, :l].copy()
    _assert_same(topk(torch.from_numpy(x), l if l <= 128 else 128, method=method),
                 *_lax(x, l if l <= 128 else 128))
    _assert_same(topk(torch.from_numpy(x), 1, method=method), *_lax(x, 1))


def test_dense_takes_k_past_the_kernel_bound():
    x = _case("ties", np.random.default_rng(3))
    _assert_same(topk(torch.from_numpy(x), 1300, method="dense"), *_lax(x, 1300))


def test_signed_zero_order_is_lax_top_k_not_the_pallas_kernel():
    # the JAX package's Pallas kernel ties +-0.0 (and writes -0.0 as +0.0);
    # lax.top_k, and the port, put +0.0 at index 1 first
    x = np.zeros((1, 1300), np.float32)
    x[0, :4] = [-0.0, 0.0, -1.0, 0.0]
    x[0, 4:] = -2.0
    for method in ("dense", "kernel"):
        v, i = topk(torch.from_numpy(x), 2, method=method)
        assert i.tolist() == [[1, 3]] and _bits(v.numpy()).tolist() == [[0, 0]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(x), 2)[1]).tolist() == [[1, 3]]


@pytest.mark.parametrize("case", ["random", "ties", "all_equal", "inf"])
@pytest.mark.parametrize("k", [1, 7])
def test_kernel_plain_matches_pallas_interpret(case, k):
    # NaN-free and without signed zeros: the inputs the Pallas kernel defines
    x = _case(case, np.random.default_rng(10 + k))
    v, i = jax_pallas_topk(jnp.asarray(x), k, interpret=True)
    _assert_same(topk_kernel_plain(torch.from_numpy(x), k), np.asarray(v), np.asarray(i))


def _radix_case(name, rng):
    """(x, k, pallas): rows that stress the kernel's radix select; ``pallas``
    marks the NaN-free, signed-zero-free inputs the Pallas kernel defines."""
    if name == "tie_group_past_a_bin":
        # the kth value 0.5 has about 4990 ties: more than a digit bin of
        # the candidate buffer (2048) holds
        x = np.full((8, 5000), 0.5, np.float32)
        for r in range(8):
            x[r, rng.choice(5000, r + 1, replace=False)] = rng.random(r + 1) + 1.0
        return x, 20, True
    if name == "all_equal":
        return np.full((4, 3000), 0.75, np.float32), 128, True
    if name == "zero_one_fewer_ones_than_k":
        x = np.zeros((6, 4000), np.float32)
        for r in range(6):
            x[r, rng.choice(4000, r, replace=False)] = 1.0
        return x, 10, True
    if name.startswith("specials_at_"):
        # +NaN x2, +inf x3, +0.0 x5, -0.0 x5, -inf x5, -NaN x5, then -NaN
        row = np.array([np.nan] * 2 + [np.inf] * 3 + [0.0] * 5 + [-0.0] * 5
                       + [-np.inf] * 5, np.float32)
        x = np.full((6, 1100), -np.nan, np.float32)
        for r in range(6):
            x[r, rng.permutation(1100)[: row.size]] = row
        k = {"specials_at_nan": 1, "specials_at_inf": 4, "specials_at_pos_zero": 7,
             "specials_at_neg_zero": 12, "specials_at_neg_inf": 18,
             "specials_at_neg_nan": 25}[name]
        return x, k, False
    if name == "k128_l1025":
        return rng.integers(-3, 4, (8, 1025)).astype(np.float32), 128, True
    if name == "l1":
        return rng.random((5, 1), dtype=np.float32), 1, False
    return rng.integers(-2, 3, (4, 37)).astype(np.float32), 37, False  # k == L


RADIX_CASES = [
    "tie_group_past_a_bin", "all_equal", "zero_one_fewer_ones_than_k",
    "specials_at_nan", "specials_at_inf", "specials_at_pos_zero", "specials_at_neg_zero",
    "specials_at_neg_inf", "specials_at_neg_nan", "k128_l1025", "l1", "k_equals_l",
]


@pytest.mark.parametrize("name", RADIX_CASES)
def test_kernel_plain_radix_select_matches_lax_top_k(name):
    x, k, _ = _radix_case(name, np.random.default_rng(12))
    _assert_same(topk_kernel_plain(torch.from_numpy(x), k), *_lax(x, k))


@pytest.mark.parametrize("name", [n for n in RADIX_CASES if _radix_case(n, np.random.default_rng(0))[2]])
def test_kernel_plain_radix_select_matches_pallas_interpret(name):
    x, k, _ = _radix_case(name, np.random.default_rng(12))
    v, i = jax_pallas_topk(jnp.asarray(x), k, interpret=True)
    _assert_same(topk_kernel_plain(torch.from_numpy(x), k), np.asarray(v), np.asarray(i))


def _prune_inputs(name, rng):
    if name == "random":
        return rng.random((37, 3000), dtype=np.float32), 5
    if name == "wide_k":
        return rng.random((16, 4096), dtype=np.float32), 20
    if name == "ties":
        return rng.integers(0, 5, (16, 2048)).astype(np.float32), 7
    if name == "valve_all_equal":
        return np.ones((16, 4096), np.float32), 5
    if name == "valve_heavy_tail":
        x = rng.random((8, 4096), dtype=np.float32)
        x[3, :128] = 2.0  # 128 survivors in group 0, past the budget of 8
        return x, 5
    if name == "valve_neg_inf":
        x = np.full((4, 2048), -np.inf, np.float32)
        x[:, 5] = 1.0
        return x, 3
    if name == "small_l":
        return rng.random((6, 256), dtype=np.float32), 4
    return rng.integers(0, 3, (9, 100)).astype(np.float32), 100  # k == L


@pytest.mark.parametrize(
    "name",
    ["random", "wide_k", "ties", "valve_all_equal", "valve_heavy_tail",
     "valve_neg_inf", "small_l", "k_equals_l"],
)
def test_prune_matches_jax_prune(name):
    x, k = _prune_inputs(name, np.random.default_rng(4))
    v, i = jax_prune_topk(jnp.asarray(x), k)
    _assert_same(prune_topk(torch.from_numpy(x), k), np.asarray(v), np.asarray(i))
    _assert_same(topk(torch.from_numpy(x), k, method="prune"), *_lax(x, k))


def test_pick_method_table():
    f32 = torch.float32
    assert _pick_method(10_000, 5, f32, "auto", CUDA) == "kernel"
    assert _pick_method(10_000, 5, f32, "auto", CPU) == "dense"
    assert _pick_method(_DENSE_L_MAX, 5, f32, "auto", CUDA) == "dense"
    assert _pick_method(_DENSE_L_MAX + 1, 5, f32, "auto", CUDA) == "kernel"
    assert _pick_method(10_000, 5, torch.int32, "auto", CUDA) == "dense"
    assert _pick_method(10_000, 5, torch.float64, "auto", CUDA) == "dense"
    assert _pick_method(10_000, _KERNEL_MAX_K, f32, "auto", CUDA) == "kernel"
    assert _pick_method(10_000, _KERNEL_MAX_K + 1, f32, "auto", CUDA) == "dense"
    assert _pick_method(2000, 2000, f32, "auto", CUDA) == "dense"
    for m in ("dense", "prune", "kernel"):
        assert _pick_method(10_000, 5, f32, m, CPU) == m
    with pytest.raises(ValueError, match="method"):
        _pick_method(10_000, 5, f32, "pallas", CPU)


def test_auto_on_cpu_runs_dense_and_launches_nothing():
    x = _case("ties", np.random.default_rng(5))
    before = topk_kernel.launches
    _assert_same(topk(torch.from_numpy(x), 5), *_lax(x, 5))
    _assert_same(topk(torch.from_numpy(x), 5, method="kernel"), *_lax(x, 5))
    assert topk_kernel.launches == before


def test_values_indices_helpers_and_other_dtypes():
    x = _case("nan", np.random.default_rng(6))
    rv, ri = _lax(x, 3)
    np.testing.assert_array_equal(_bits(topk_values(torch.from_numpy(x), 3).numpy()), _bits(rv))
    np.testing.assert_array_equal(topk_indices(torch.from_numpy(x), 3).numpy(), ri)
    ints = np.random.default_rng(7).integers(-5, 5, (8, 1500)).astype(np.int32)
    v, i = topk(torch.from_numpy(ints), 4)
    rv, ri = _lax(ints, 4)
    np.testing.assert_array_equal(v.numpy(), rv)
    np.testing.assert_array_equal(i.numpy(), ri)
    # a forced kernel casts to float32, as the JAX package's forced pallas
    _assert_same(topk(torch.from_numpy(ints), 4, method="kernel"), rv.astype(np.float32), ri)


def test_order_key_decodes_bit_for_bit():
    x = torch.from_numpy(_case("nan", np.random.default_rng(8)))
    assert torch.equal(_flip(order_key(x)), x.view(torch.int32))
    h = x.to(torch.float16)
    assert torch.equal(_flip(order_key(h)), h.view(torch.int16))


def test_validation():
    with pytest.raises(ValueError, match="k="):
        topk(torch.zeros(4, 8), 0)
    with pytest.raises(ValueError, match="2-D"):
        topk(torch.zeros(8), 2)
    with pytest.raises(TypeError, match="integer"):
        topk(torch.zeros(4, 8), np.int64(2))
    with pytest.raises(ValueError, match="method"):
        topk(torch.zeros(4, 8), 2, method="radix")
    with pytest.raises(ValueError, match="k="):
        topk(torch.zeros(4, 16), 17, method="kernel")
    with pytest.raises(ValueError, match="min\\(L, 128\\)"):
        topk_kernel(torch.zeros(4, 4096), _KERNEL_MAX_K + 1)
    with pytest.raises(TypeError, match="float32"):
        topk_kernel_plain(torch.zeros(4, 4096, dtype=torch.float64), 3)
