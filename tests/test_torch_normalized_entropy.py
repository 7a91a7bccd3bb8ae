"""The port's binary normalized entropy (functional and class) against the
JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through ``torcheval_tpu`` and
``torcheval_tpu_torch`` (``device="cpu"``): probabilities and logits,
weights, one and three tasks, merges and collections. Values within atol
1e-8 / rtol 1e-5 (both accumulate in float32, in different orders); the
JAX package's error messages exactly.
"""

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu_torch.metrics import BinaryNormalizedEntropy, MetricCollection
from torcheval_tpu_torch.metrics.functional import binary_normalized_entropy
from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _ne_value_check,
)

RTOL, ATOL = 1e-5, 1e-8
CPU = "cpu"


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


def _batch(seed, num_tasks, from_logits, n=61):
    rng = np.random.default_rng(seed)
    shape = (n,) if num_tasks == 1 else (num_tasks, n)
    x = (rng.standard_normal(shape) * 3).astype(np.float32) if from_logits else (
        rng.random(shape).astype(np.float32))
    t = (rng.random(shape) < 0.35).astype(np.float32)
    w = (rng.random(shape) + 0.1).astype(np.float32)
    return x, t, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("from_logits", [False, True])
@pytest.mark.parametrize("num_tasks", [1, 3])
def test_functional_matches_jax(num_tasks, from_logits, weighted):
    x, t, w = _batch(1, num_tasks, from_logits)
    kw = dict(num_tasks=num_tasks, from_logits=from_logits, weight=w if weighted else None)
    got = binary_normalized_entropy(x, t, **kw)
    _close(got, JF.binary_normalized_entropy(x, t, **kw))
    assert got.dtype == torch.float32


def test_extreme_probabilities_clamp_like_jax():
    # log(0) is clamped at -100, as in the reference's binary cross entropy
    x = np.array([0.0, 1.0, 1.0, 0.0, 0.5], np.float32)
    t = np.array([1.0, 0.0, 1.0, 0.0, 1.0], np.float32)
    _close(binary_normalized_entropy(x, t), JF.binary_normalized_entropy(x, t))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("from_logits", [False, True])
@pytest.mark.parametrize("num_tasks", [1, 3])
def test_class_streams_and_merges_like_jax(num_tasks, from_logits, weighted):
    kw = dict(num_tasks=num_tasks, from_logits=from_logits)
    a, b = BinaryNormalizedEntropy(device=CPU, **kw), BinaryNormalizedEntropy(device=CPU, **kw)
    ja, jb = J.BinaryNormalizedEntropy(**kw), J.BinaryNormalizedEntropy(**kw)
    for i in range(6):
        x, t, w = _batch(10 + i, num_tasks, from_logits)
        ukw = {"weight": w} if weighted else {}
        (a if i % 2 else b).update(x, t, **ukw)
        (ja if i % 2 else jb).update(x, t, **ukw)
    _close(b.compute(), jb.compute())
    a.merge_state([b])
    ja.merge_state([jb])
    _close(a.compute(), ja.compute())
    for name, value in a.state_dict().items():
        assert value.shape == (num_tasks,) and value.dtype == torch.float32
        _close(value, np.asarray(ja.state_dict()[name]))


def test_compute_before_any_update_is_empty_like_jax():
    m, jm = BinaryNormalizedEntropy(num_tasks=2, device=CPU), J.BinaryNormalizedEntropy(num_tasks=2)
    assert m.compute().shape == (0,) == np.asarray(jm.compute()).shape


@pytest.mark.parametrize("ragged", [False, True])
def test_collection_window_equals_jax(ragged):
    col = MetricCollection({"ne": BinaryNormalizedEntropy(num_tasks=3, from_logits=True, device=CPU)})
    jm = J.BinaryNormalizedEntropy(num_tasks=3, from_logits=True)
    for i in range(5):
        x, t, _ = _batch(20 + i, 3, True, n=30 + i if ragged else 61)
        col.update(torch.from_numpy(x), torch.from_numpy(t))
        jm.update(x, t)
    _close(col.compute()["ne"], jm.compute())


def _raises_like_jax(port_call, jax_call):
    with pytest.raises(ValueError) as jax_err:
        jax_call()
    with pytest.raises(ValueError) as port_err:
        port_call()
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("case", ["above_one", "below_zero", "target_shape", "weight_shape",
                                  "one_task_2d", "tasks_rows"])
def test_input_errors_match_jax(case):
    x, t, w = _batch(30, 3, False)
    x1, t1, _ = _batch(31, 1, False)
    args, kw = {
        "above_one": ((x1 + 1.0, t1), {}),
        "below_zero": ((x1 - 1.0, t1), {}),
        "target_shape": ((x, t[:2]), {"num_tasks": 3}),
        "weight_shape": ((x, t), {"num_tasks": 3, "weight": w[:2]}),
        "one_task_2d": ((x, t), {}),
        "tasks_rows": ((x, t), {"num_tasks": 2}),
    }[case]
    _raises_like_jax(lambda: binary_normalized_entropy(*args, **kw),
                     lambda: JF.binary_normalized_entropy(*args, **kw))
    num_tasks = kw.pop("num_tasks", 1)
    _raises_like_jax(lambda: BinaryNormalizedEntropy(num_tasks=num_tasks, device=CPU).update(*args, **kw),
                     lambda: J.BinaryNormalizedEntropy(num_tasks=num_tasks).update(*args, **kw))


def test_num_tasks_must_be_positive_like_jax():
    _raises_like_jax(lambda: BinaryNormalizedEntropy(num_tasks=0, device=CPU),
                     lambda: J.BinaryNormalizedEntropy(num_tasks=0))


def test_logits_skip_the_probability_check():
    x, t, _ = _batch(40, 1, True)
    _close(binary_normalized_entropy(x, t, from_logits=True),
           JF.binary_normalized_entropy(x, t, from_logits=True))


@pytest.mark.parametrize("source", ["numpy", "cpu_tensor"])
def test_value_check_reads_host_resident_sources(source):
    bad = np.array([0.5, 1.5], np.float32)
    with pytest.raises(ValueError, match="probability"):
        _ne_value_check(bad if source == "numpy" else torch.from_numpy(bad), False)


def test_value_check_never_reads_a_device_tensor():
    # a tensor off the host (the meta device stands in for the card here)
    # is never read back for validation, so nothing raises
    _ne_value_check(torch.full((4,), 2.0, device="meta"), False)
