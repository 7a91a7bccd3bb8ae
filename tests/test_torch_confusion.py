"""The port's confusion matrices (``ops/confusion.py::confusion_matrix_counts``,
the functional and class metrics) against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through ``torcheval_tpu`` and
``torcheval_tpu_torch`` (``device="cpu"``, where the histogram runs its
plain version). Counts must be equal exactly; normalised matrices within
rtol 1e-5, atol 1e-8. The JAX package counts small batches with a one-hot
matmul and large ones with a scatter; both branches are held here.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu.ops.confusion import _CONFUSION_MATMUL_ONEHOT_ELEMS
from torcheval_tpu.ops.confusion import confusion_matrix_counts as jax_cm
from torcheval_tpu_torch.metrics import (
    BinaryConfusionMatrix,
    MetricCollection,
    MulticlassConfusionMatrix,
    MulticlassF1Score,
)
from torcheval_tpu_torch.metrics.functional import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
)
from torcheval_tpu_torch.ops.confusion import class_counts, confusion_matrix_counts
from torcheval_tpu_torch.ops.hist import hist
from torcheval_tpu_torch.utils.jax_state import load_jax_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils import NUM_TOTAL_UPDATES, MetricClassTester

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-8
C = 5
NORMALIZE = [None, "all", "pred", "true"]


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=RTOL, atol=ATOL
    )


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _labels(n, classes, seed, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    hi = classes if hi is None else hi
    return rng.integers(lo, hi, n).astype(np.int32), rng.integers(lo, hi, n).astype(np.int32)


# ---------------------------------------------------------------------- ops
@pytest.mark.parametrize(
    "n,classes",
    [(500, 7), (1 << 19, 2048)],
    ids=["jax_onehot_matmul_branch", "jax_scatter_branch"],
)
def test_counts_equal_both_jax_branches(n, classes):
    assert (n * classes > _CONFUSION_MATMUL_ONEHOT_ELEMS) == (classes > 7)
    pred, target = _labels(n, classes, seed=n, lo=-2, hi=classes + 2)
    got = confusion_matrix_counts(torch.from_numpy(pred), torch.from_numpy(target), classes)
    _equal(got, jax_cm(jnp.asarray(pred), jnp.asarray(target), classes))


def test_row_is_target_and_column_is_prediction():
    # asymmetric: every sample of class 0 predicted 2, one of class 1 predicted 0
    target = torch.tensor([0, 0, 0, 1, 2])
    pred = torch.tensor([2, 2, 2, 0, 2])
    got = confusion_matrix_counts(pred, target, 3)
    assert got.tolist() == [[0, 0, 3], [1, 0, 0], [0, 0, 1]]
    _equal(got.to(torch.int32), jax_cm(jnp.asarray(pred.numpy()), jnp.asarray(target.numpy()), 3))


def test_a_pair_with_one_coordinate_out_of_range_drops():
    pred = torch.tensor([0, 1, 3, -1, 1, 2, 7], dtype=torch.int32)
    target = torch.tensor([0, 3, 1, 1, -1, 2, 0], dtype=torch.int32)
    got = confusion_matrix_counts(pred, target, 3)
    assert int(got.sum()) == 2 and int(got[0, 0]) == 1 and int(got[2, 2]) == 1
    _equal(got, jax_cm(jnp.asarray(pred.numpy()), jnp.asarray(target.numpy()), 3))


@pytest.mark.parametrize("dtypes", [(np.int64, np.int64), (np.int32, np.int64), (np.float32, np.int32)])
def test_label_types(dtypes):
    pred, target = _labels(400, C, seed=1)
    pred, target = pred.astype(dtypes[0]), target.astype(dtypes[1])
    got = confusion_matrix_counts(torch.from_numpy(pred), torch.from_numpy(target), C)
    _equal(got, jax_cm(jnp.asarray(pred), jnp.asarray(target), C))


@pytest.mark.parametrize("normalize", NORMALIZE, ids=str)
def test_normalize_matches_jax(normalize):
    pred, target = _labels(300, C, seed=2)
    target[target == 3] = 4  # an empty row
    pred[pred == 1] = 0  # an empty column
    got = confusion_matrix_counts(torch.from_numpy(pred), torch.from_numpy(target), C, normalize=normalize)
    want = jax_cm(jnp.asarray(pred), jnp.asarray(target), C, normalize=normalize)
    if normalize is None:
        _equal(got, want)
    else:
        assert got.dtype == torch.float32
        _close(got, want)


def test_confusion_counts_run_on_the_histogram_and_vmap():
    before = hist.launches
    pred, target = _labels(64, 4, seed=3)
    p, t = torch.from_numpy(pred).reshape(4, 16), torch.from_numpy(target).reshape(4, 16)
    got = torch.func.vmap(lambda a, b: confusion_matrix_counts(a, b, 4))(p, t)
    for i in range(4):
        _equal(got[i], jax_cm(jnp.asarray(pred[16 * i:16 * i + 16]), jnp.asarray(target[16 * i:16 * i + 16]), 4))
    assert hist.launches == before  # CPU tensors: the plain version


def test_weighted_class_counts_batch_under_vmap():
    rng = np.random.default_rng(4)
    labels = torch.from_numpy(rng.integers(-1, 6, (3, 40)))
    weights = torch.from_numpy(rng.integers(-2, 3, (3, 40)).astype(np.int32))
    got = torch.func.vmap(lambda a, w: class_counts(a, 5, weights=w))(labels, weights)
    for i in range(3):
        valid = (labels[i] >= 0) & (labels[i] < 5)
        want = np.bincount(labels[i][valid].numpy(), weights=weights[i][valid].numpy(), minlength=5)
        np.testing.assert_array_equal(got[i].numpy(), want.astype(np.int32))
        assert got.dtype == torch.int32


# --------------------------------------------------------------- functional
@pytest.mark.parametrize("normalize", NORMALIZE, ids=str)
@pytest.mark.parametrize("form", ["scores", "labels"])
def test_functional_multiclass_matches_jax(normalize, form):
    rng = np.random.default_rng(5)
    scores = rng.random((250, C)).astype(np.float32)
    target = rng.integers(0, C, 250)
    x = scores if form == "scores" else scores.argmax(1)
    got = multiclass_confusion_matrix(x, target, C, normalize=normalize)
    want = JF.multiclass_confusion_matrix(x, target, C, normalize=normalize)
    _equal(got, want) if normalize is None else _close(got, want)


@pytest.mark.parametrize("normalize", [None, "true"], ids=str)
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_functional_binary_matches_jax(normalize, threshold):
    rng = np.random.default_rng(6)
    x = rng.random(300).astype(np.float32)
    x[:5] = np.nan  # predicted 1, as JAX's where(input < threshold, 0, 1)
    t = (rng.random(300) < 0.4).astype(np.int64)
    got = binary_confusion_matrix(x, t, threshold=threshold, normalize=normalize)
    want = JF.binary_confusion_matrix(x, t, threshold=threshold, normalize=normalize)
    _equal(got, want) if normalize is None else _close(got, want)


def test_parameter_and_shape_checks_match_jax():
    with pytest.raises(ValueError, match="at least 2"):
        multiclass_confusion_matrix(torch.zeros(4), torch.zeros(4), 1)
    with pytest.raises(ValueError, match="normalize"):
        multiclass_confusion_matrix(torch.zeros(4), torch.zeros(4), 3, normalize="rows")
    with pytest.raises(ValueError, match="normalize"):
        binary_confusion_matrix(torch.zeros(4), torch.zeros(4), normalize="rows")
    with pytest.raises(ValueError, match="first dimension"):
        multiclass_confusion_matrix(torch.zeros(4), torch.zeros(3), 3)
    with pytest.raises(ValueError, match="one-dimensional"):
        multiclass_confusion_matrix(torch.zeros(4, 3), torch.zeros(4, 3), 3)
    with pytest.raises(ValueError, match="num_sample, num_classes"):
        multiclass_confusion_matrix(torch.zeros(4, 2), torch.zeros(4), 3)
    with pytest.raises(ValueError, match="at least 2"):
        MulticlassConfusionMatrix(1, device=CPU)


# ------------------------------------------------------------ class metrics
def _stream(seed, n=NUM_TOTAL_UPDATES, batch=16, classes=C):
    rng = np.random.default_rng(seed)
    return rng.random((n, batch, classes)).astype(np.float32), rng.integers(0, classes, (n, batch))


class TestConfusionClasses(MetricClassTester):
    def _run(self, port, ref, update_kwargs):
        for i in range(NUM_TOTAL_UPDATES):
            ref.update(*(np.asarray(v[i]) for v in update_kwargs.values()))
        want = np.array(ref.compute())
        self.run_class_implementation_tests(
            metric=port,
            state_names={"confusion_matrix"},
            update_kwargs=update_kwargs,
            compute_result=torch.from_numpy(want),
            atol=ATOL,
            rtol=RTOL,
        )
        stream = copy.deepcopy(port)
        for i in range(NUM_TOTAL_UPDATES):
            stream.update(**{k: v[i] for k, v in update_kwargs.items()})
        _equal(stream.state_dict()["confusion_matrix"], ref.state_dict()["confusion_matrix"])

    def test_multiclass_every_normalize(self):
        scores, labels = _stream(seed=7)
        for normalize in NORMALIZE:
            with self.subTest(normalize=normalize):
                self._run(
                    MulticlassConfusionMatrix(C, normalize=normalize, device=CPU),
                    J.MulticlassConfusionMatrix(C, normalize=normalize),
                    {"input": torch.from_numpy(scores), "target": torch.from_numpy(labels)},
                )

    def test_multiclass_on_labels(self):
        scores, labels = _stream(seed=8)
        self._run(
            MulticlassConfusionMatrix(C, device=CPU),
            J.MulticlassConfusionMatrix(C),
            {"input": torch.from_numpy(scores.argmax(-1)), "target": torch.from_numpy(labels)},
        )

    def test_binary(self):
        rng = np.random.default_rng(9)
        x = rng.random((NUM_TOTAL_UPDATES, 32)).astype(np.float32)
        t = (rng.random((NUM_TOTAL_UPDATES, 32)) < 0.4).astype(np.int64)
        self._run(
            BinaryConfusionMatrix(threshold=0.4, device=CPU),
            J.BinaryConfusionMatrix(threshold=0.4),
            {"input": torch.from_numpy(x), "target": torch.from_numpy(t)},
        )


def test_state_dict_mid_window_and_carried_both_ways():
    scores, labels = _stream(seed=10)
    half = NUM_TOTAL_UPDATES // 2
    ref = J.MulticlassConfusionMatrix(C)
    for i in range(NUM_TOTAL_UPDATES):
        ref.update(scores[i], labels[i])
    port = MulticlassConfusionMatrix(C, device=CPU)
    j = J.MulticlassConfusionMatrix(C)
    for i in range(half):
        port.update(scores[i], labels[i])
        j.update(scores[i], labels[i])
    assert port._pending  # mid-window: state_dict folds first
    _equal(port.state_dict()["confusion_matrix"], j.state_dict()["confusion_matrix"])
    # JAX first half -> port second half, and back
    there = MulticlassConfusionMatrix(C, device=CPU)
    load_jax_state_dict(there, {k: np.asarray(v) for k, v in j.state_dict().items()})
    back = J.MulticlassConfusionMatrix(C)
    back.load_state_dict(numpy_state_dict(port))
    for i in range(half, NUM_TOTAL_UPDATES):
        there.update(scores[i], labels[i])
        back.update(scores[i], labels[i])
    _equal(there.compute(), ref.compute())
    _equal(np.asarray(back.compute()), ref.compute())


def test_collection_window_with_f1_matches_jax():
    # BASELINE config 3's pairing, at a small size: the confusion matrix and
    # macro F1 fold the whole window in one step
    rng = np.random.default_rng(11)
    classes = 12
    batches = [
        (rng.integers(0, classes, 64).astype(np.int32), rng.integers(0, classes, 64).astype(np.int32))
        for _ in range(6)
    ]
    port = MetricCollection({
        "cm": MulticlassConfusionMatrix(classes, device=CPU),
        "f1": MulticlassF1Score(num_classes=classes, average="macro", device=CPU),
    })
    ref = J.MetricCollection({
        "cm": J.MulticlassConfusionMatrix(classes),
        "f1": J.MulticlassF1Score(num_classes=classes, average="macro"),
    })
    for p, t in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(p, t)
    assert len(port._window.chunks) == len(batches)
    got, want = port.compute(), ref.compute()
    _equal(got["cm"], want["cm"])
    _close(got["f1"], want["f1"])
    p = np.concatenate([b[0] for b in batches])
    t = np.concatenate([b[1] for b in batches])
    np.testing.assert_array_equal(
        got["cm"].numpy().ravel(), np.bincount(t * classes + p, minlength=classes * classes)
    )
