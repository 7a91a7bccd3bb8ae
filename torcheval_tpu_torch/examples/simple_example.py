"""Single-device training loop with a streaming metric.

JAX counterpart: ``examples/simple_example.py``. A small MLP (layer sizes
128, 64, 32, 2) trains with SGD at lr 0.05 for 4 epochs of 16 batches of 8,
while ``MulticlassAccuracy()`` (micro) streams over each batch's logits:
``compute()`` every 4 batches, ``reset()`` at each epoch. The initial
weights (normal times sqrt(2 / fan-in), zero biases) and the data come from
explicit generators, so every run prints the same lines.

Run on the card:

    python -m torcheval_tpu_torch.examples.simple_example

``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from torcheval_tpu_torch.metrics import MulticlassAccuracy
from torcheval_tpu_torch.utils.devices import canonical_device

NUM_EPOCHS = 4
NUM_BATCHES = 16
BATCH_SIZE = 8
NUM_CLASSES = 2
LAYER_SIZES = (128, 64, 32, NUM_CLASSES)
LEARNING_RATE = 0.05
COMPUTE_FREQUENCY = 4
INIT_SEED = 42
DATA_SEED = 0


class MLP(torch.nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.layers = torch.nn.ModuleList(
            torch.nn.Linear(d_in, d_out) for d_in, d_out in zip(LAYER_SIZES[:-1], LAYER_SIZES[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


def init_params(seed: int = INIT_SEED) -> Dict[str, torch.Tensor]:
    """The MLP's initial ``state_dict``: normal weights scaled by
    sqrt(2 / fan-in), zero biases, drawn from a generator seeded ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for i, (d_in, d_out) in enumerate(zip(LAYER_SIZES[:-1], LAYER_SIZES[1:])):
        params[f"layers.{i}.weight"] = torch.randn(d_out, d_in, generator=gen) * (2.0 / d_in) ** 0.5
        params[f"layers.{i}.bias"] = torch.zeros(d_out)
    return params


def make_data(seed: int = DATA_SEED) -> Tuple[torch.Tensor, torch.Tensor]:
    """``NUM_BATCHES * BATCH_SIZE`` standard normal rows of 128 features and
    their labels in ``[0, NUM_CLASSES)``, drawn from a generator seeded
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    n = NUM_BATCHES * BATCH_SIZE
    data = torch.randn(n, LAYER_SIZES[0], generator=gen)
    labels = torch.randint(0, NUM_CLASSES, (n,), generator=gen)
    return data, labels


def run(
    device=None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    data: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, Any]:
    """Train and stream the metric on ``device`` (default ``cuda:0``),
    from ``params`` (an MLP ``state_dict``) and ``data`` (rows, labels) when
    given. Returns ``records``, one ``{epoch, batch, loss, accuracy}`` per
    printed line, ``lines``, the printed lines, ``logits`` and ``labels``,
    what the metric was fed, as ``(NUM_EPOCHS * NUM_BATCHES, BATCH_SIZE,
    ...)`` CPU tensors, and ``device``, where it ran."""
    dev = canonical_device(device)
    model = MLP()
    model.load_state_dict(init_params() if params is None else params)
    model.to(dev)
    rows, labels = make_data() if data is None else data
    rows, labels = rows.to(dev), labels.to(dev, torch.int64)
    opt = torch.optim.SGD(model.parameters(), lr=LEARNING_RATE)
    metric = MulticlassAccuracy(device=dev)
    records, lines, fed = [], [], []
    for epoch in range(NUM_EPOCHS):
        for batch_idx in range(NUM_BATCHES):
            lo, hi = batch_idx * BATCH_SIZE, (batch_idx + 1) * BATCH_SIZE
            x, y = rows[lo:hi], labels[lo:hi]
            logits = model(x)
            loss = torch.nn.functional.cross_entropy(logits, y)
            opt.zero_grad()
            loss.backward()
            opt.step()
            logits = logits.detach()
            metric.update(logits, y)
            fed.append(logits)
            if (batch_idx + 1) % COMPUTE_FREQUENCY == 0:
                rec = {"epoch": epoch + 1, "batch": batch_idx + 1, "loss": float(loss.detach()),
                       "accuracy": float(metric.compute())}
                line = (f"Epoch {rec['epoch']}/{NUM_EPOCHS}, Batch {rec['batch']}/{NUM_BATCHES} --- "
                        f"loss: {rec['loss']:.4f}, acc: {rec['accuracy']:.4f}")
                print(line)
                records.append(rec)
                lines.append(line)
        # reset the metric between epochs, as in the reference loop
        metric.reset()
    return {
        "device": dev,
        "records": records,
        "lines": lines,
        "logits": torch.stack(fed).cpu(),
        "labels": labels.reshape(NUM_BATCHES, BATCH_SIZE).repeat(NUM_EPOCHS, 1).cpu(),
    }


def main(
    argv: Optional[Sequence[str]] = None,
    *,
    device=None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    data: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, Any]:
    """The example from the command line (``--device``), or with
    ``device``, ``params`` and ``data`` given by the caller (as
    :func:`run`)."""
    if device is None:
        parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
        parser.add_argument("--device", default=None, help="cpu, or a CUDA device (default: cuda:0)")
        device = parser.parse_args(argv).device
    return run(device, params, data)


if __name__ == "__main__":
    main()
