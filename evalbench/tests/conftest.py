"""Shared helpers of the harness's tests (CPU; the card's test carries the
``cuda`` marker and skips without a card)."""

import time

import torch

from evalbench.core import harness
from evalbench.core.spec import Spec

# small passes that a CPU test holds: rows a pass and rows a batch
SMALL = {
    "criteo1tb_ctr_eval.whole": (120_000, 120_000),
    "imagenet1k_val_eval.b256": (2_000, 256),
    "imagenet1k_val_eval.whole": (2_000, 2_000),
}


def small_run(cell_name, *, spec=None, seed=2**31 + 7, trace=False, program_factory=None,
              rows=None, batch=None):
    """One run of a cell on the CPU at a small size, as the harness runs it
    on the card (the look for a card left out)."""
    spec = spec or Spec()
    rows, batch = SMALL.get(cell_name, (rows, batch))
    cell = harness.Cell(spec, cell_name, rows=rows, batch_rows=batch)
    return harness.measure(cell, seed, 0.05, trace, torch.device("cpu"),
                           t0=time.perf_counter(), program_factory=program_factory)
