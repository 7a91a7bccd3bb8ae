"""The port's accuracy against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through ``torcheval_tpu`` and
``torcheval_tpu_torch`` (``device="cpu"``). Counts are compared exactly and
accuracies within the repo's tolerance (rtol 1e-5, atol 1e-8).
"""

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
from torcheval_tpu.metrics.functional import binary_accuracy as jax_binary_accuracy
from torcheval_tpu.metrics.functional import multiclass_accuracy as jax_multiclass_accuracy
from torcheval_tpu_torch.metrics import BinaryAccuracy, MulticlassAccuracy
from torcheval_tpu_torch.metrics.functional import binary_accuracy, multiclass_accuracy

RTOL, ATOL = 1e-5, 1e-8


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
        rtol=RTOL, atol=ATOL, equal_nan=True,
    )


def _data(n=600, c=7, seed=0):
    rng = np.random.default_rng(seed)
    scores = rng.random((n, c)).astype(np.float32)
    scores[:20, 1] = scores[:20, 3] = 2.0  # tied rows: argmax takes the first
    labels = rng.integers(0, c, n)
    return scores, labels


@pytest.mark.parametrize("average", ["micro", "macro", "none", None])
@pytest.mark.parametrize("k", [1, 3])
def test_functional_multiclass_matches_jax(average, k):
    scores, labels = _data()
    got = multiclass_accuracy(scores, labels, average=average, num_classes=7, k=k)
    want = jax_multiclass_accuracy(scores, labels, average=average, num_classes=7, k=k)
    _close(got, want)


def test_functional_label_input_and_absent_class():
    rng = np.random.default_rng(1)
    preds = rng.integers(0, 4, 300)
    labels = rng.integers(0, 3, 300)  # class 3 never appears in target
    for average in ("micro", "macro", None):
        _close(
            multiclass_accuracy(preds, labels, average=average, num_classes=4),
            jax_multiclass_accuracy(preds, labels, average=average, num_classes=4),
        )


def test_functional_binary_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.random(500).astype(np.float32)
    t = (rng.random(500) < 0.4).astype(np.float32)
    for threshold in (0.5, 0.3):
        _close(
            binary_accuracy(x, t, threshold=threshold),
            jax_binary_accuracy(x, t, threshold=threshold),
        )


@pytest.mark.parametrize("average", ["micro", "macro", None])
@pytest.mark.parametrize("k", [1, 2])
def test_streaming_multiclass_matches_jax(average, k):
    scores, labels = _data(n=900, seed=3)
    ours = MulticlassAccuracy(average=average, num_classes=7, k=k, device="cpu")
    theirs = J.MulticlassAccuracy(average=average, num_classes=7, k=k)
    for i in range(0, 900, 250):
        ours.update(scores[i:i + 250], labels[i:i + 250])
        theirs.update(scores[i:i + 250], labels[i:i + 250])
    folded = theirs.state_dict()  # the JAX metric defers its folds
    np.testing.assert_array_equal(ours.num_correct.numpy(), np.asarray(folded["num_correct"]))
    np.testing.assert_array_equal(ours.num_total.numpy(), np.asarray(folded["num_total"]))
    assert ours.num_correct.dtype == torch.int32
    _close(ours.compute(), theirs.compute())


def test_streaming_binary_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.random(700).astype(np.float32)
    t = (rng.random(700) < 0.5).astype(np.float32)
    ours, theirs = BinaryAccuracy(threshold=0.6, device="cpu"), J.BinaryAccuracy(threshold=0.6)
    for i in range(0, 700, 300):
        ours.update(x[i:i + 300], t[i:i + 300])
        theirs.update(x[i:i + 300], t[i:i + 300])
    _close(ours.compute(), theirs.compute())


def test_merge_reset_and_state_dict():
    scores, labels = _data(n=800, seed=5)
    whole = MulticlassAccuracy(average="macro", num_classes=7, device="cpu")
    whole.update(scores, labels)
    a = MulticlassAccuracy(average="macro", num_classes=7, device="cpu").update(
        scores[:300], labels[:300]
    )
    b = MulticlassAccuracy(average="macro", num_classes=7, device="cpu").update(
        scores[300:], labels[300:]
    )
    a.merge_state([b])
    assert torch.equal(a.num_correct, whole.num_correct)
    _close(a.compute(), whole.compute())
    # a state_dict is a copy: later updates do not reach it
    sd = whole.state_dict()
    whole.update(scores[:10], labels[:10])
    restored = MulticlassAccuracy(average="macro", num_classes=7, device="cpu")
    restored.load_state_dict(sd)
    _close(restored.compute(), a.compute())
    with pytest.raises(RuntimeError, match="missing keys"):
        restored.load_state_dict({"num_correct": sd["num_correct"]})
    restored.reset()
    assert int(restored.num_total.sum()) == 0


def test_param_and_input_checks():
    with pytest.raises(ValueError, match="average"):
        MulticlassAccuracy(average="weighted", device="cpu")
    with pytest.raises(ValueError, match="num_classes"):
        MulticlassAccuracy(average="macro", device="cpu")
    with pytest.raises(ValueError, match="greater than 0"):
        MulticlassAccuracy(k=0, device="cpu")
    m = MulticlassAccuracy(num_classes=3, device="cpu")
    with pytest.raises(ValueError, match="first dimension"):
        m.update(torch.rand(4, 3), torch.zeros(5, dtype=torch.int64))
    with pytest.raises(ValueError, match="shape"):
        BinaryAccuracy(device="cpu").update(torch.rand(4), torch.rand(5))
