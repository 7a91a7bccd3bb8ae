"""The port's F1 metrics and ``match_triple_counts`` against the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through ``torcheval_tpu`` and
``torcheval_tpu_torch`` (``device="cpu"``, where the histogram runs its
plain version). Counts are compared exactly and scores within rtol 1e-5,
atol 1e-8. The class metrics run through the port's ``MetricClassTester``,
which also holds merged replicas equal to one stream.
"""

import copy
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu.ops.confusion import _MATMUL_ELEMENT_BUDGET
from torcheval_tpu.ops.confusion import match_triple_counts as jax_triple
from torcheval_tpu_torch.metrics import BinaryF1Score, MulticlassF1Score, SlicedMetricCollection
from torcheval_tpu_torch.metrics.functional import binary_f1_score, multiclass_f1_score
from torcheval_tpu_torch.utils.tracing import join_pending
from torcheval_tpu_torch.ops.confusion import match_triple_counts
from torcheval_tpu_torch.utils.jax_state import load_jax_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils import NUM_TOTAL_UPDATES, MetricClassTester
from torcheval_tpu_torch.utils.test_utils.obs_counts import launches, recording


@pytest.fixture
def obs_on():
    """The obs registry on (and reset) for a test that counts launches,
    folds or rounds: the registry is the port's one counter."""
    with recording():
        yield


CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-8
C = 5
AVERAGES = ["micro", "macro", "weighted", None]
_STATES = ("num_tp", "num_label", "num_prediction")


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=RTOL, atol=ATOL
    )


def _data(seed=0, n=NUM_TOTAL_UPDATES, batch=16, classes=C, absent=None):
    rng = np.random.default_rng(seed)
    scores = rng.random((n, batch, classes)).astype(np.float32)
    labels = rng.integers(0, classes, (n, batch))
    if absent is not None:  # a class that never appears as a label
        labels[labels == absent] = (absent + 1) % classes
    return scores, labels


# ---------------------------------------------------------------- functional
@pytest.mark.parametrize("average", AVERAGES, ids=str)
@pytest.mark.parametrize("form", ["scores", "labels"])
def test_functional_multiclass_f1_matches_jax(average, form):
    scores, labels = _data(seed=1, n=1, batch=200, absent=3)
    x = scores[0] if form == "scores" else scores[0].argmax(1)
    got = multiclass_f1_score(x, labels[0], num_classes=C, average=average)
    _close(got, JF.multiclass_f1_score(x, labels[0], num_classes=C, average=average))


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_functional_binary_f1_matches_jax(threshold):
    rng = np.random.default_rng(2)
    x = rng.random(300).astype(np.float32)
    t = (rng.random(300) < 0.4).astype(np.float32)
    _close(binary_f1_score(x, t, threshold=threshold), JF.binary_f1_score(x, t, threshold=threshold))


def test_parameter_and_shape_checks_match_jax():
    with pytest.raises(ValueError, match="average"):
        multiclass_f1_score(torch.zeros(4), torch.zeros(4), average="samples")
    with pytest.raises(ValueError, match="num_classes"):
        MulticlassF1Score(average="macro", device=CPU)
    with pytest.raises(ValueError, match="first dimension"):
        multiclass_f1_score(torch.zeros(4), torch.zeros(3))
    with pytest.raises(ValueError, match="one-dimensional"):
        multiclass_f1_score(torch.zeros(4, 2), torch.zeros(4, 2), num_classes=2, average="macro")
    with pytest.raises(ValueError, match="num_sample, num_classes"):
        multiclass_f1_score(torch.zeros(4, 3), torch.zeros(4), num_classes=2, average="macro")
    with pytest.raises(ValueError, match="same dimensions"):
        binary_f1_score(torch.zeros(4), torch.zeros(3))


def test_empty_class_warning(caplog):
    scores, labels = _data(seed=3, n=1, batch=50, absent=2)
    with caplog.at_level(logging.WARNING):
        multiclass_f1_score(scores[0], labels[0], num_classes=C, average="macro")
        assert join_pending(timeout=30)  # the warning is logged on a daemon thread
    assert any("do not exist in the target" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        MulticlassF1Score(num_classes=C, average="macro", device=CPU).update(scores[0], labels[0]).compute()
        assert join_pending(timeout=30)
    assert any("do not exist in the target" in r.message for r in caplog.records)


# ------------------------------------------------------- match_triple_counts
def _triple_case(n, classes, seed):
    rng = np.random.default_rng(seed)
    pred = rng.integers(-2, classes + 2, n).astype(np.int32)
    target = rng.integers(-2, classes + 2, n).astype(np.int32)
    target[: n // 3] = pred[: n // 3]  # plenty of hits
    return pred, target


@pytest.mark.parametrize(
    "n,classes",
    [(1000, 7), ((1 << 18) + 1, 1 << 12)],
    ids=["under_the_matmul_budget", "over_the_matmul_budget"],
)
def test_match_triple_counts_equals_both_jax_branches(n, classes):
    pred, target = _triple_case(n, classes, seed=n)
    over = n * classes > _MATMUL_ELEMENT_BUDGET
    assert over == (classes > 7)  # each case takes the JAX branch it names
    got = match_triple_counts(torch.from_numpy(pred), torch.from_numpy(target), classes)
    want = jax_triple(jnp.asarray(pred), jnp.asarray(target), classes)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_match_triple_counts_is_two_histograms(obs_on):
    before = launches("hist")
    pred, target = _triple_case(500, 4, seed=5)
    got = match_triple_counts(torch.from_numpy(pred).long(), torch.from_numpy(target).long(), 4)
    # a CPU tensor runs the plain version: no launch, the same counts
    assert launches("hist") == before
    valid = (target >= 0) & (target < 4)
    np.testing.assert_array_equal(got[1].numpy(), np.bincount(target[valid], minlength=4))
    hits = valid & (pred == target)
    np.testing.assert_array_equal(got[0].numpy(), np.bincount(target[hits], minlength=4))


# ------------------------------------------------------------- class metrics
class TestF1Classes(MetricClassTester):
    def _ref_states(self, ref):
        sd = ref.state_dict()
        return [np.asarray(sd[n]) for n in _STATES]

    def _run(self, port, ref, update_kwargs):
        n = NUM_TOTAL_UPDATES
        for i in range(n):
            ref.update(*(np.asarray(v[i]) for v in update_kwargs.values()))
        self.run_class_implementation_tests(
            metric=port,
            state_names=set(_STATES),
            update_kwargs=update_kwargs,
            compute_result=torch.from_numpy(np.array(ref.compute(), np.float32)),
            atol=ATOL,
            rtol=RTOL,
        )
        # counts exactly
        stream = copy.deepcopy(port)
        for i in range(n):
            stream.update(**{k: v[i] for k, v in update_kwargs.items()})
        folded = stream.state_dict()
        for got, want in zip((folded[s] for s in _STATES), self._ref_states(ref)):
            np.testing.assert_array_equal(got.numpy(), want)

    def test_multiclass_every_average(self):
        scores, labels = _data(seed=4, absent=1)
        for average in AVERAGES:
            with self.subTest(average=average):
                self._run(
                    MulticlassF1Score(num_classes=C, average=average, device=CPU),
                    J.MulticlassF1Score(num_classes=C, average=average),
                    {"input": torch.from_numpy(scores), "target": torch.from_numpy(labels)},
                )

    def test_multiclass_on_labels(self):
        scores, labels = _data(seed=5)
        self._run(
            MulticlassF1Score(num_classes=C, average="macro", device=CPU),
            J.MulticlassF1Score(num_classes=C, average="macro"),
            {"input": torch.from_numpy(scores.argmax(-1)), "target": torch.from_numpy(labels)},
        )

    def test_binary(self):
        rng = np.random.default_rng(6)
        x = rng.random((NUM_TOTAL_UPDATES, 32)).astype(np.float32)
        t = (rng.random((NUM_TOTAL_UPDATES, 32)) < 0.4).astype(np.float32)
        self._run(
            BinaryF1Score(threshold=0.4, device=CPU),
            J.BinaryF1Score(threshold=0.4),
            {"input": torch.from_numpy(x), "target": torch.from_numpy(t)},
        )


@pytest.mark.parametrize("average", ["macro", None], ids=str)
def test_state_carried_both_ways_with_jax(average):
    scores, labels = _data(seed=7)
    half = NUM_TOTAL_UPDATES // 2
    ref = J.MulticlassF1Score(num_classes=C, average=average)
    for i in range(NUM_TOTAL_UPDATES):
        ref.update(scores[i], labels[i])
    # JAX first half -> port second half
    j = J.MulticlassF1Score(num_classes=C, average=average)
    for i in range(half):
        j.update(scores[i], labels[i])
    port = MulticlassF1Score(num_classes=C, average=average, device=CPU)
    load_jax_state_dict(port, {k: np.asarray(v) for k, v in j.state_dict().items()})
    for i in range(half, NUM_TOTAL_UPDATES):
        port.update(scores[i], labels[i])
    _close(port.compute(), ref.compute())
    # port first half -> JAX second half
    p = MulticlassF1Score(num_classes=C, average=average, device=CPU)
    for i in range(half):
        p.update(scores[i], labels[i])
    back = J.MulticlassF1Score(num_classes=C, average=average)
    back.load_state_dict(numpy_state_dict(p))
    for i in range(half, NUM_TOTAL_UPDATES):
        back.update(scores[i], labels[i])
    _close(back.compute(), ref.compute())


def test_sliced_f1_equals_jax():
    rng = np.random.default_rng(8)
    port = SlicedMetricCollection({"f1": MulticlassF1Score(num_classes=C, average="macro", device=CPU)})
    ref = J.SlicedMetricCollection({"f1": J.MulticlassF1Score(num_classes=C, average="macro")})
    for _ in range(3):
        ids = rng.integers(0, 6, 120) * 11
        s = rng.random((120, C)).astype(np.float32)
        t = rng.integers(0, C, 120)
        port.update(ids, s, t)
        ref.update(ids, s, t)
    got, want = port.compute()["f1"], ref.compute()["f1"]
    np.testing.assert_array_equal(got["slice_ids"], np.asarray(want["slice_ids"]))
    _close(got["values"], want["values"])
