"""Data-parallel evaluation with one process per card.

JAX counterpart: ``examples/distributed_example.py``. The same stream (seed
2023, 64 global batches of (256, 4) scores and labels) feeds the same
metrics: ``MulticlassAccuracy`` and macro ``MulticlassF1Score`` in one
``ShardedEvaluator``, and ``BinaryAUROC`` on class 0's score against
``labels == 0`` in another. Every rank draws each global batch and feeds
its own block of it (``shard_batch``); ``compute()`` syncs the states over
the ranks, so every rank holds the global result, and rank 0 prints it.

Run with one process per card:

    torchrun --nproc_per_node=4 -m torcheval_tpu_torch.examples.distributed_example

or as a world of one:

    python -m torcheval_tpu_torch.examples.distributed_example

``--device cpu`` runs the metrics on the CPU, over gloo.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from torcheval_tpu_torch.metrics import BinaryAUROC, MulticlassAccuracy, MulticlassF1Score
from torcheval_tpu_torch.parallel import (
    ShardedEvaluator,
    data_parallel_mesh,
    init_from_env,
    shard_batch,
    shutdown,
)

NUM_BATCHES = 64
BATCH_SIZE = 256
NUM_CLASSES = 4
SEED = 2023


def run(device=None) -> Dict[str, float]:
    """Evaluate the stream on this rank's blocks; returns the global
    ``accuracy``, ``f1_macro`` and ``auroc`` (the same on every rank). The
    world must already be initialised, or be a world of one."""
    mesh = data_parallel_mesh(device=device)
    classification = ShardedEvaluator(
        {
            "accuracy": MulticlassAccuracy(num_classes=NUM_CLASSES, device=mesh.device),
            "f1_macro": MulticlassF1Score(
                num_classes=NUM_CLASSES, average="macro", device=mesh.device
            ),
        },
        mesh=mesh,
    )
    auroc = ShardedEvaluator(BinaryAUROC(device=mesh.device), mesh=mesh)
    rng = np.random.default_rng(SEED)
    for _ in range(NUM_BATCHES):
        scores = rng.random((BATCH_SIZE, NUM_CLASSES)).astype(np.float32)
        labels = rng.integers(0, NUM_CLASSES, BATCH_SIZE)
        local_scores, local_labels = shard_batch(mesh, scores, labels)
        classification.update(local_scores, local_labels)
        # one-vs-rest margin for class 0 feeds the binary AUROC
        auroc.update(local_scores[:, 0], (local_labels == 0).float())
    results = classification.compute()
    return {
        "accuracy": float(results["accuracy"]),
        "f1_macro": float(results["f1_macro"]),
        "auroc": float(auroc.compute()),
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="cpu, or a CUDA device (default: cuda:LOCAL_RANK)")
    args = parser.parse_args(argv)
    rank, world = init_from_env(device=args.device)
    try:
        results = run(args.device)
    finally:
        shutdown()
    if rank == 0:
        print(f"world: {world} rank(s)")
        print(f"accuracy: {results['accuracy']:.8f}")
        print(f"f1_macro: {results['f1_macro']:.8f}")
        print(f"auroc:    {results['auroc']:.8f}")
    return results


if __name__ == "__main__":
    main()
