"""Evaluating a PyTorch model with the port's metrics.

JAX counterpart: ``examples/torch_bridge_example.py``. There a torch model's
outputs cross a bridge into JAX; here the model's output tensors go straight
into ``update()`` on the same device, with no conversion step. A
``TinyTorchNet`` (16 -> 32 -> 4), its init seeded, trains for 200 Adam
steps on batches of 256 labelled by a random linear teacher, then 24 batches
of 256 are evaluated with ``MulticlassAccuracy`` and macro
``MulticlassF1Score`` in one ``MetricCollection`` and ``BinaryAUROC`` on
class 0's softmax score against ``labels == 0``. The macro F1 launches the
histogram kernel (``csrc/hist.cu``) on the card.

Run on the card:

    python -m torcheval_tpu_torch.examples.torch_bridge_example

``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from torcheval_tpu_torch.metrics import (
    BinaryAUROC,
    MetricCollection,
    MulticlassAccuracy,
    MulticlassF1Score,
)
from torcheval_tpu_torch.utils.devices import canonical_device

NUM_CLASSES = 4
BATCH, N_BATCHES = 256, 24
TRAIN_STEPS = 200
DATA_SEED = 0
INIT_SEED = 0


class TinyTorchNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.net = torch.nn.Sequential(
            torch.nn.Linear(16, 32),
            torch.nn.ReLU(),
            torch.nn.Linear(32, NUM_CLASSES),
        )

    def forward(self, x):
        return self.net(x)


def make_batch(rng: np.random.Generator, w_true: np.ndarray, device: torch.device):
    x = rng.standard_normal((BATCH, 16)).astype(np.float32)
    y = (x @ w_true).argmax(1)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def run(device=None) -> Dict[str, Any]:
    """Train and evaluate on ``device`` (default ``cuda:0``). Returns
    ``accuracy``, ``f1_macro`` and ``auroc``, the evaluation's ``logits``
    and ``labels`` as ``(N_BATCHES, BATCH, ...)`` CPU tensors, and
    ``device``, where it ran."""
    dev = canonical_device(device)
    rng = np.random.default_rng(DATA_SEED)
    w_true = rng.standard_normal((16, NUM_CLASSES)).astype(np.float32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(INIT_SEED)
        model = TinyTorchNet()
    model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)

    # brief training so the evaluation below measures something real
    for _ in range(TRAIN_STEPS):
        x, y = make_batch(rng, w_true, dev)
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()

    metrics = MetricCollection(
        {
            "acc": MulticlassAccuracy(num_classes=NUM_CLASSES, device=dev),
            "f1": MulticlassF1Score(num_classes=NUM_CLASSES, average="macro", device=dev),
        }
    )
    auroc = BinaryAUROC(device=dev)  # one-vs-rest on class 0, streamed separately
    fed_logits, fed_labels = [], []
    model.eval()
    with torch.no_grad():
        for _ in range(N_BATCHES):
            x, y = make_batch(rng, w_true, dev)
            logits = model(x)
            # the model's tensors go straight in, on the metrics' device
            metrics.update(logits, y)
            auroc.update(torch.softmax(logits, dim=1)[:, 0], (y == 0).float())
            fed_logits.append(logits)
            fed_labels.append(y)

    results = metrics.compute()
    return {
        "device": dev,
        "accuracy": float(results["acc"]),
        "f1_macro": float(results["f1"]),
        "auroc": float(auroc.compute()),
        "logits": torch.stack(fed_logits).cpu(),
        "labels": torch.stack(fed_labels).cpu(),
    }


def main(argv: Optional[Sequence[str]] = None, *, device=None) -> Dict[str, Any]:
    """The example from the command line (``--device``), or on ``device``;
    prints and returns what :func:`run` returns."""
    if device is None:
        parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
        parser.add_argument("--device", default=None, help="cpu, or a CUDA device (default: cuda:0)")
        device = parser.parse_args(argv).device
    out = run(device)
    print(f"accuracy: {out['accuracy']:.4f}")
    print(f"f1_macro: {out['f1_macro']:.4f}")
    print(f"auroc(class 0): {out['auroc']:.4f}")
    return out


if __name__ == "__main__":
    main()
