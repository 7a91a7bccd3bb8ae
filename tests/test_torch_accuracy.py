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
from torcheval_tpu.metrics.functional import multilabel_accuracy as jax_multilabel_accuracy
from torcheval_tpu.metrics.functional import (
    topk_multilabel_accuracy as jax_topk_multilabel_accuracy,
)
from torcheval_tpu_torch.metrics import (
    BinaryAccuracy,
    MulticlassAccuracy,
    MultilabelAccuracy,
    TopKMultilabelAccuracy,
)
from torcheval_tpu_torch.metrics.functional import (
    binary_accuracy,
    multiclass_accuracy,
    multilabel_accuracy,
    topk_multilabel_accuracy,
)
from torcheval_tpu_torch.ops.topk import topk_kernel

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


# --------------------------------------------------------------- multilabel
CRITERIA = ["exact_match", "hamming", "overlap", "contain", "belong"]


def _multilabel_data(n=400, c=1300, seed=0, ties=False):
    """Scores past the top-k engine's dense threshold (1024 labels) and
    sparse int32 targets; with ``ties`` the scores are quantised to 4 levels,
    so the top-k set rests on the lowest-index tie order."""
    rng = np.random.default_rng(seed)
    scores = rng.random((n, c), dtype=np.float32)
    if ties:
        scores = np.floor(scores * 4) / 4
    target = (rng.random((n, c)) < 0.002).astype(np.int32)
    target[:10, :3] = 1  # rows whose positives are the top of a tie
    return scores, target


@pytest.mark.parametrize("criteria", CRITERIA)
@pytest.mark.parametrize("threshold", [0.5, 0.999])
def test_functional_multilabel_matches_jax(criteria, threshold):
    scores, target = _multilabel_data(n=300, c=12, seed=7)
    target = (np.random.default_rng(8).random((300, 12)) < 0.4).astype(np.int32)
    target[:5] = (scores[:5] >= threshold)  # exact matches exist
    _close(
        multilabel_accuracy(scores, target, threshold=threshold, criteria=criteria),
        jax_multilabel_accuracy(scores, target, threshold=threshold, criteria=criteria),
    )


@pytest.mark.parametrize("criteria", CRITERIA)
@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("ties", [False, True])
def test_functional_topk_multilabel_matches_jax(criteria, k, ties):
    scores, target = _multilabel_data(seed=9 + k, ties=ties)
    want = jax_topk_multilabel_accuracy(scores, target, criteria=criteria, k=k)
    for method in ("auto", "dense", "prune", "kernel"):
        got = topk_multilabel_accuracy(
            scores, target, criteria=criteria, k=k, topk_method=method
        )
        _close(got, want)


@pytest.mark.parametrize("criteria", CRITERIA)
def test_streaming_multilabel_matches_jax(criteria):
    rng = np.random.default_rng(11)
    scores = rng.random((500, 9)).astype(np.float32)
    target = (rng.random((500, 9)) < 0.5).astype(np.float32)
    ours = MultilabelAccuracy(threshold=0.6, criteria=criteria, device="cpu")
    theirs = J.MultilabelAccuracy(threshold=0.6, criteria=criteria)
    for i in range(0, 500, 200):
        ours.update(scores[i:i + 200], target[i:i + 200])
        theirs.update(scores[i:i + 200], target[i:i + 200])
    folded = theirs.state_dict()
    assert int(ours.num_correct) == int(folded["num_correct"])
    assert int(ours.num_total) == int(folded["num_total"])
    _close(ours.compute(), theirs.compute())


@pytest.mark.parametrize("criteria", CRITERIA)
@pytest.mark.parametrize("k", [2, 5])
def test_streaming_topk_multilabel_matches_jax(criteria, k):
    scores, target = _multilabel_data(seed=12 + k, ties=True)
    before = topk_kernel.launches
    ours = TopKMultilabelAccuracy(criteria=criteria, k=k, device="cpu")
    theirs = J.TopKMultilabelAccuracy(criteria=criteria, k=k)
    for i in range(0, 400, 150):
        ours.update(scores[i:i + 150], target[i:i + 150])
        theirs.update(scores[i:i + 150], target[i:i + 150])
    folded = theirs.state_dict()
    assert ours.num_correct.dtype == torch.int32
    assert int(ours.num_correct) == int(folded["num_correct"])
    assert int(ours.num_total) == int(folded["num_total"])
    _close(ours.compute(), theirs.compute())
    assert topk_kernel.launches == before  # CPU tensors: the plain versions


def test_topk_multilabel_all_equal_scores():
    # every score ties: the top-k set is the first k labels
    scores = np.ones((8, 2048), np.float32)
    target = np.zeros((8, 2048), np.int32)
    target[:, :5] = 1
    for method in ("dense", "prune", "kernel"):
        got = topk_multilabel_accuracy(scores, target, criteria="contain", k=5, topk_method=method)
        assert float(got) == 1.0


def test_multilabel_param_and_input_checks():
    with pytest.raises(ValueError, match="criteria"):
        MultilabelAccuracy(criteria="all", device="cpu")
    with pytest.raises(ValueError, match="greater than 1"):
        TopKMultilabelAccuracy(k=1, device="cpu")
    with pytest.raises(TypeError, match="integer"):
        TopKMultilabelAccuracy(k=2.0, device="cpu")
    # updates fold at once, but a typo in the method is refused before any
    with pytest.raises(ValueError, match="topk_method"):
        TopKMultilabelAccuracy(k=2, topk_method="pallas", device="cpu")
    with pytest.raises(ValueError, match="dimensions"):
        MultilabelAccuracy(device="cpu").update(torch.rand(4, 3), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="k > 1"):
        TopKMultilabelAccuracy(device="cpu").update(torch.rand(4), torch.zeros(4))
