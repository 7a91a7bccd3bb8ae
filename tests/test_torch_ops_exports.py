"""``torcheval_tpu_torch.ops`` exports the JAX package's ``ops.__all__``
under the port's names, and ``torcheval_tpu_torch.utils`` exports
``to_numpy`` as ``torcheval_tpu.utils`` does.

``ops.JAX_NAMES`` maps each JAX name to its port name and
``ops.NO_COUNTERPART`` each of the others to a reason; together they must
cover the JAX ``__all__`` exactly, and ``JAX_NAMES``' values must be the
port's ``__all__``, each a callable of the package.
"""

import numpy as np
import pytest
import torch

import torcheval_tpu.ops as jax_ops
import torcheval_tpu.utils as jax_utils
import torcheval_tpu_torch.ops as ops
import torcheval_tpu_torch.utils as utils


def test_tables_cover_the_jax_all_exactly():
    assert not set(ops.JAX_NAMES) & set(ops.NO_COUNTERPART)
    assert set(ops.JAX_NAMES) | set(ops.NO_COUNTERPART) == set(jax_ops.__all__)
    assert len(ops.JAX_NAMES) == 15 and all(ops.NO_COUNTERPART.values())


def test_port_all_is_the_tables_values():
    assert sorted(ops.__all__) == sorted(ops.JAX_NAMES.values())
    assert len(set(ops.__all__)) == len(ops.__all__)


@pytest.mark.parametrize("jax_name", sorted(ops.JAX_NAMES))
def test_each_name_imports_from_the_package(jax_name):
    port_name = ops.JAX_NAMES[jax_name]
    assert callable(getattr(ops, port_name))
    assert callable(getattr(jax_ops, jax_name))
    ns = {}
    exec(f"from torcheval_tpu_torch.ops import {port_name}", ns)
    assert ns[port_name] is getattr(ops, port_name)


def test_class_counts_from_the_package_matches_jax():
    from torcheval_tpu.ops import class_counts as jax_class_counts
    from torcheval_tpu_torch.ops import class_counts

    labels = np.random.default_rng(0).integers(0, 7, 200).astype(np.int32)
    got = class_counts(torch.from_numpy(labels), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_class_counts(labels, 7)))


def test_utils_all_matches_jax_but_as_jax():
    assert set(utils.__all__) == (set(jax_utils.__all__) - {"as_jax"}) | {"as_tensor"}


@pytest.mark.parametrize(
    "x", [torch.arange(6.0).reshape(2, 3), torch.ones(3, requires_grad=True), [1, 2], 3.5]
)
def test_to_numpy(x):
    got = utils.to_numpy(x)
    assert isinstance(got, np.ndarray)
    want = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_utils.to_numpy(want))
