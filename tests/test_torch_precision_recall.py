"""The port's precision and recall (functional and class metrics) against
the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through ``torcheval_tpu`` and
``torcheval_tpu_torch`` (``device="cpu"``, where the histogram runs its
plain version). The count triples must be equal exactly; the values agree
within rtol 1e-5, atol 1e-8.
"""

import copy
import logging

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.metrics.functional as JF
from torcheval_tpu_torch.metrics import (
    BinaryPrecision,
    BinaryRecall,
    MetricCollection,
    MulticlassPrecision,
    MulticlassRecall,
    SlicedMetricCollection,
)
from torcheval_tpu_torch.metrics.functional import (
    binary_precision,
    binary_recall,
    multiclass_precision,
    multiclass_recall,
)
from torcheval_tpu_torch.utils.jax_state import load_jax_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils import NUM_TOTAL_UPDATES, MetricClassTester

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-8
C = 6
PRECISION_AVERAGES = ["micro", "macro", "weighted", None, "None"]
RECALL_AVERAGES = ["micro", "macro", "weighted", None]
PRECISION_STATES = ("num_tp", "num_fp", "num_label")
RECALL_STATES = ("num_tp", "num_labels", "num_predictions")
FAMILIES = {
    "precision": (multiclass_precision, JF.multiclass_precision, binary_precision, JF.binary_precision),
    "recall": (multiclass_recall, JF.multiclass_recall, binary_recall, JF.binary_recall),
}


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=RTOL, atol=ATOL
    )


def _data(seed=0, n=NUM_TOTAL_UPDATES, batch=24, classes=C, absent=None, never_predicted=None):
    rng = np.random.default_rng(seed)
    scores = rng.random((n, batch, classes)).astype(np.float32)
    labels = rng.integers(0, classes, (n, batch))
    if absent is not None:  # a class that never appears as a label
        labels[labels == absent] = (absent + 1) % classes
    if never_predicted is not None:  # nor as a prediction
        scores[..., never_predicted] = -1.0
    return scores, labels


# ---------------------------------------------------------------- functional
@pytest.mark.parametrize(
    "family,average",
    [("precision", a) for a in PRECISION_AVERAGES] + [("recall", a) for a in RECALL_AVERAGES],
    ids=str,
)
@pytest.mark.parametrize("form", ["scores", "labels"])
def test_functional_multiclass_matches_jax(family, average, form):
    port, ref = FAMILIES[family][:2]
    scores, labels = _data(seed=1, n=1, batch=300, absent=2, never_predicted=2)
    x = scores[0] if form == "scores" else scores[0].argmax(1)
    got = port(x, labels[0], num_classes=C, average=average)
    _close(got, ref(x, labels[0], num_classes=C, average=average))


@pytest.mark.parametrize("family", ["precision", "recall"])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
@pytest.mark.parametrize("targets", ["binary", "weights", "floats"])
def test_functional_binary_matches_jax(family, threshold, targets):
    rng = np.random.default_rng(2)
    x = rng.random(300).astype(np.float32)
    x[:4] = np.nan
    t = (rng.random(300) < 0.4).astype(np.float32)
    if targets == "weights":  # JAX ANDs the 0/1 prediction with the int32 target
        t = rng.integers(-1, 4, 300).astype(np.int32)
    elif targets == "floats":  # truncated to int32 first
        t = (rng.random(300) * 2.5).astype(np.float32)
    port, ref = FAMILIES[family][2:]
    _close(port(x, t, threshold=threshold), ref(x, t, threshold=threshold))


def test_binary_recall_with_no_positive_warns_and_is_zero(caplog):
    x = np.linspace(0, 1, 20, dtype=np.float32)
    t = np.zeros(20, np.float32)
    with caplog.at_level(logging.WARNING):
        got = binary_recall(x, t)
    assert float(got) == 0.0 == float(JF.binary_recall(x, t))
    assert any("no ground-truth instances" in r.message for r in caplog.records)


def test_parameter_and_shape_checks_match_jax():
    with pytest.raises(ValueError, match="average"):
        multiclass_precision(torch.zeros(4), torch.zeros(4), average="samples")
    with pytest.raises(ValueError, match="average"):
        multiclass_recall(torch.zeros(4), torch.zeros(4), average="None")
    with pytest.raises(ValueError, match="num_classes"):
        MulticlassPrecision(average="macro", device=CPU)
    with pytest.raises(ValueError, match="num_classes"):
        MulticlassRecall(average="weighted", device=CPU)
    for fn in (multiclass_precision, multiclass_recall):
        with pytest.raises(ValueError, match="first dimension"):
            fn(torch.zeros(4), torch.zeros(3))
        with pytest.raises(ValueError, match="one-dimensional"):
            fn(torch.zeros(4, 2), torch.zeros(4, 2), num_classes=2, average="macro")
        with pytest.raises(ValueError, match="num_sample, num_classes"):
            fn(torch.zeros(4, 3), torch.zeros(4), num_classes=2, average="macro")
    for fn in (binary_precision, binary_recall):
        with pytest.raises(ValueError, match="same dimensions"):
            fn(torch.zeros(4), torch.zeros(3))


def test_warnings_for_empty_classes(caplog):
    scores, labels = _data(seed=3, n=1, batch=60, absent=1, never_predicted=1)
    with caplog.at_level(logging.WARNING):
        multiclass_precision(scores[0], labels[0], num_classes=C, average=None)
    assert any("[1] classes have zero instances" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        MulticlassRecall(num_classes=C, average="macro", device=CPU).update(scores[0], labels[0]).compute()
    assert any("ground-truth instances of [1]" in r.message for r in caplog.records)


# ------------------------------------------------------------- class metrics
class TestPrecisionRecallClasses(MetricClassTester):
    def _run(self, port, ref, states, update_kwargs):
        for i in range(NUM_TOTAL_UPDATES):
            ref.update(*(np.asarray(v[i]) for v in update_kwargs.values()))
        self.run_class_implementation_tests(
            metric=port,
            state_names=set(states),
            update_kwargs=update_kwargs,
            compute_result=torch.from_numpy(np.array(ref.compute(), np.float32)),
            atol=ATOL,
            rtol=RTOL,
        )
        stream = copy.deepcopy(port)
        for i in range(NUM_TOTAL_UPDATES):
            stream.update(**{k: v[i] for k, v in update_kwargs.items()})
        got, want = stream.state_dict(), ref.state_dict()
        for name in states:
            assert got[name].dtype == torch.int32
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))

    def test_multiclass_precision_every_average(self):
        scores, labels = _data(seed=4, absent=3)
        for average in PRECISION_AVERAGES:
            with self.subTest(average=average):
                self._run(
                    MulticlassPrecision(num_classes=C, average=average, device=CPU),
                    J.MulticlassPrecision(num_classes=C, average=average),
                    PRECISION_STATES,
                    {"input": torch.from_numpy(scores), "target": torch.from_numpy(labels)},
                )

    def test_multiclass_recall_every_average(self):
        scores, labels = _data(seed=5, absent=3)
        for average in RECALL_AVERAGES:
            with self.subTest(average=average):
                self._run(
                    MulticlassRecall(num_classes=C, average=average, device=CPU),
                    J.MulticlassRecall(num_classes=C, average=average),
                    RECALL_STATES,
                    {"input": torch.from_numpy(scores), "target": torch.from_numpy(labels)},
                )

    def test_binary_precision_and_recall(self):
        rng = np.random.default_rng(6)
        x = rng.random((NUM_TOTAL_UPDATES, 32)).astype(np.float32)
        t = rng.integers(0, 3, (NUM_TOTAL_UPDATES, 32)).astype(np.int32)  # 2 is a weight
        kwargs = {"input": torch.from_numpy(x), "target": torch.from_numpy(t)}
        self._run(BinaryPrecision(threshold=0.4, device=CPU), J.BinaryPrecision(threshold=0.4),
                  PRECISION_STATES, kwargs)
        self._run(BinaryRecall(threshold=0.4, device=CPU), J.BinaryRecall(threshold=0.4),
                  ("num_tp", "num_true_labels"), kwargs)


@pytest.mark.parametrize(
    "make,ref",
    [
        (lambda: MulticlassPrecision(num_classes=C, average="macro", device=CPU),
         lambda: J.MulticlassPrecision(num_classes=C, average="macro")),
        (lambda: MulticlassRecall(num_classes=C, average=None, device=CPU),
         lambda: J.MulticlassRecall(num_classes=C, average=None)),
    ],
    ids=["precision", "recall"],
)
def test_state_dict_mid_window_and_carried_both_ways(make, ref):
    scores, labels = _data(seed=7)
    half = NUM_TOTAL_UPDATES // 2
    whole = ref()
    for i in range(NUM_TOTAL_UPDATES):
        whole.update(scores[i], labels[i])
    port, j = make(), ref()
    for i in range(half):
        port.update(scores[i], labels[i])
        j.update(scores[i], labels[i])
    assert port._pending
    for name, value in port.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(j.state_dict()[name]))
    there = make()
    load_jax_state_dict(there, {k: np.asarray(v) for k, v in j.state_dict().items()})
    back = ref()
    back.load_state_dict(numpy_state_dict(port))
    for i in range(half, NUM_TOTAL_UPDATES):
        there.update(scores[i], labels[i])
        back.update(scores[i], labels[i])
    _close(there.compute(), whole.compute())
    _close(back.compute(), whole.compute())


def test_collection_window_matches_jax():
    scores, labels = _data(seed=8, batch=40)
    port = MetricCollection({
        "precision": MulticlassPrecision(num_classes=C, average="weighted", device=CPU),
        "recall": MulticlassRecall(num_classes=C, average="macro", device=CPU),
    })
    ref = J.MetricCollection({
        "precision": J.MulticlassPrecision(num_classes=C, average="weighted"),
        "recall": J.MulticlassRecall(num_classes=C, average="macro"),
    })
    for i in range(NUM_TOTAL_UPDATES):
        port.update(torch.from_numpy(scores[i]), torch.from_numpy(labels[i]))
        ref.update(scores[i], labels[i])
    assert len(port._window.chunks) == NUM_TOTAL_UPDATES
    got, want = port.compute(), ref.compute()
    for name in ("precision", "recall"):
        _close(got[name], want[name])


def test_sliced_precision_equals_jax():
    rng = np.random.default_rng(9)
    port = SlicedMetricCollection({"p": MulticlassPrecision(num_classes=C, average="macro", device=CPU)})
    ref = J.SlicedMetricCollection({"p": J.MulticlassPrecision(num_classes=C, average="macro")})
    for _ in range(3):
        ids = rng.integers(0, 5, 90) * 7
        s = rng.random((90, C)).astype(np.float32)
        t = rng.integers(0, C, 90)
        port.update(ids, s, t)
        ref.update(ids, s, t)
    got, want = port.compute()["p"], ref.compute()["p"]
    np.testing.assert_array_equal(got["slice_ids"], np.asarray(want["slice_ids"]))
    _close(got["values"], want["values"])
