"""The port's examples against the JAX package's.

``torcheval_tpu_torch/examples/simple_example.py`` starts from the JAX
example's initial parameters (carried across by ``utils/jax_state.py``) and
its data, and runs the same 64 SGD steps: each printed loss within rtol 1e-4
of the JAX run's (two float32 trainings drift apart by their rounding), each
printed accuracy equal. The bridge example's logits go through the JAX
metrics and the port's: accuracy equal, F1 and AUROC within rtol 1e-5."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from torcheval_tpu.metrics import BinaryAUROC as JaxBinaryAUROC
from torcheval_tpu.metrics import MetricCollection as JaxMetricCollection
from torcheval_tpu.metrics import MulticlassAccuracy as JaxMulticlassAccuracy
from torcheval_tpu.metrics import MulticlassF1Score as JaxMulticlassF1Score
from torcheval_tpu_torch.examples import simple_example, torch_bridge_example
from torcheval_tpu_torch.metrics import (
    BinaryAUROC,
    MetricCollection,
    MulticlassAccuracy,
    MulticlassF1Score,
)
from torcheval_tpu_torch.utils.jax_state import flax_dense_kernel

ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-4
RTOL = 1e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_simple():
    """The JAX example's run, step for step as its ``main()``: its initial
    parameters and data, and ``{epoch, batch, loss, accuracy}`` at each
    printed line."""
    ex = _load("simple_example")
    params = ex.init_params(jax.random.PRNGKey(42))
    initial = [{k: np.asarray(v) for k, v in layer.items()} for layer in params]
    data_key, label_key = jax.random.split(jax.random.PRNGKey(0))
    n = ex.NUM_BATCHES * ex.BATCH_SIZE
    data = jax.random.normal(data_key, (n, 128))
    labels = jax.random.randint(label_key, (n,), 0, ex.NUM_CLASSES)
    metric = JaxMulticlassAccuracy()
    records = []
    for epoch in range(ex.NUM_EPOCHS):
        for batch_idx in range(ex.NUM_BATCHES):
            lo, hi = batch_idx * ex.BATCH_SIZE, (batch_idx + 1) * ex.BATCH_SIZE
            x, y = data[lo:hi], labels[lo:hi]
            params, loss, logits = ex.train_step(params, x, y)
            metric.update(logits, y)
            if (batch_idx + 1) % 4 == 0:
                records.append({"epoch": epoch + 1, "batch": batch_idx + 1, "loss": float(loss),
                                "accuracy": float(metric.compute())})
        metric.reset()
    return {"initial": initial, "data": np.asarray(data), "labels": np.asarray(labels),
            "records": records}


def test_simple_example_matches_the_jax_example_step_for_step(jax_simple, capsys):
    params = {}
    for i, layer in enumerate(jax_simple["initial"]):
        params[f"layers.{i}.weight"] = flax_dense_kernel(layer["w"])
        params[f"layers.{i}.bias"] = torch.tensor(layer["b"])
    data = (torch.tensor(jax_simple["data"]), torch.tensor(jax_simple["labels"]))
    out = simple_example.main(device="cpu", params=params, data=data)
    assert capsys.readouterr().out.splitlines() == out["lines"]
    want = jax_simple["records"]
    assert len(out["records"]) == len(want) == 16
    for got, exp in zip(out["records"], want):
        where = f"epoch {exp['epoch']}, batch {exp['batch']}"
        assert (got["epoch"], got["batch"]) == (exp["epoch"], exp["batch"])
        assert abs(got["loss"] - exp["loss"]) <= LOSS_RTOL * abs(exp["loss"]), (
            f"{where}: loss {got['loss']} vs the JAX example's {exp['loss']}")
        assert got["accuracy"] == exp["accuracy"], (
            f"{where}: accuracy {got['accuracy']} vs the JAX example's {exp['accuracy']} "
            f"(by {got['accuracy'] - exp['accuracy']:+.6f}: an argmax that flipped)")
    # what the metric was fed replays to the printed values
    assert out["logits"].shape == (64, 8, 2) and out["labels"].shape == (64, 8)
    assert _replayed_accuracies(out) == [r["accuracy"] for r in out["records"]]


def _replayed_accuracies(out):
    values, metric = [], MulticlassAccuracy(device="cpu")
    for step in range(out["logits"].shape[0]):
        metric.update(out["logits"][step], out["labels"][step])
        if (step + 1) % 4 == 0:
            values.append(float(metric.compute()))
        if (step + 1) % 16 == 0:
            metric.reset()
    return values


def test_simple_example_from_its_own_generators(capsys):
    out = simple_example.main(device="cpu")
    assert len(capsys.readouterr().out.splitlines()) == 16
    assert out["lines"][0].startswith("Epoch 1/4, Batch 4/16 --- loss: ")
    losses = [r["loss"] for r in out["records"]]
    assert np.mean(losses[-4:]) < np.mean(losses[:4])
    again = simple_example.main(device="cpu")
    assert again["lines"] == out["lines"]


def test_simple_example_command_line(capsys):
    out = simple_example.main(["--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == out["lines"]


@pytest.fixture(scope="module")
def bridge():
    return torch_bridge_example.main(device="cpu")


def test_bridge_example_prints_its_values(capsys):
    out = torch_bridge_example.main(["--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == [
        f"accuracy: {out['accuracy']:.4f}",
        f"f1_macro: {out['f1_macro']:.4f}",
        f"auroc(class 0): {out['auroc']:.4f}",
    ]


def test_bridge_example_matches_the_jax_metrics(bridge):
    n = torch_bridge_example.NUM_CLASSES
    jax_col = JaxMetricCollection({"acc": JaxMulticlassAccuracy(num_classes=n),
                                   "f1": JaxMulticlassF1Score(num_classes=n, average="macro")})
    jax_auroc = JaxBinaryAUROC()
    port_col = MetricCollection({"acc": MulticlassAccuracy(num_classes=n, device="cpu"),
                                 "f1": MulticlassF1Score(num_classes=n, average="macro", device="cpu")})
    port_auroc = BinaryAUROC(device="cpu")
    assert bridge["logits"].shape == (24, 256, n) and bridge["labels"].shape == (24, 256)
    for logits, labels in zip(bridge["logits"], bridge["labels"]):
        score = torch.softmax(logits, dim=1)[:, 0]
        hit = (labels == 0).float()
        jax_col.update(logits.numpy(), labels.numpy())
        jax_auroc.update(score.numpy(), hit.numpy())
        port_col.update(logits, labels)
        port_auroc.update(score, hit)
    want, port = jax_col.compute(), port_col.compute()
    got = (bridge["accuracy"], bridge["f1_macro"], bridge["auroc"])
    assert got[0] == float(want["acc"]) == float(port["acc"])
    for value in (float(port["f1"]), got[1]):
        assert value == pytest.approx(float(want["f1"]), rel=RTOL, abs=0)
    for value in (float(port_auroc.compute()), got[2]):
        assert value == pytest.approx(float(jax_auroc.compute()), rel=RTOL, abs=0)
    assert 0.9 < got[0] <= 1.0  # the trained model evaluates something real


def test_bridge_example_is_seeded(bridge):
    again = torch_bridge_example.main(device="cpu")
    assert torch.equal(again["logits"], bridge["logits"])
    assert (again["accuracy"], again["f1_macro"], again["auroc"]) == (
        bridge["accuracy"], bridge["f1_macro"], bridge["auroc"])
