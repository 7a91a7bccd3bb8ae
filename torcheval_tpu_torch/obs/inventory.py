"""The port's instrument inventory: every name it records, and how its
labels map onto the JAX package's.

JAX counterpart: the "Metric inventory" table of ``docs/observability.md``,
which fixes the JAX package's names. The port records a subset of those
names (no ``serve.*`` yet: the serve plane is not ported) and no name of
its own; ``tests/test_torch_obs_inventory.py`` holds the code, this table
and that document to each other.

Three tables:

* :data:`INSTRUMENTS`: ``name -> (kind, label keys)`` for every counter,
  gauge and histogram literal under ``torcheval_tpu_torch/``;
* :data:`ENTRIES`: each ``entry=`` label the port writes (its own function
  names) -> the JAX package's entry for the same function;
* :data:`LABEL_VALUES`: ``(instrument, label key) -> {port value: JAX
  value}`` where the port's value differs: a JAX value that names a TPU
  lowering becomes ``cuda`` for the hand kernel and ``torch`` for the
  library or plain route. Values not listed are the JAX ones.

Spans are not enumerated, as in the JAX document: ``metric.<method>/<cls>``,
``collection.*``, ``evaluator.*``, ``toolkit.*``, ``toolkit.sync.round``,
``jit/<entry>``, ``jit.compile/<entry>``, ``obs.cost.capture``,
``obs.sync_snapshot``, ``ops.dist_curves.*`` and the checkpoint spans.
"""

from __future__ import annotations

from typing import Dict, Tuple

COUNTER, GAUGE, HISTOGRAM = "counter", "gauge", "histogram"

INSTRUMENTS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "bootstrap.retries": (COUNTER, ()),
    "deferred.folds": (COUNTER, ("entry", "path")),
    "deferred.folded_chunks": (COUNTER, ("entry",)),
    "deferred.window_steps": (COUNTER, ("path",)),
    "deferred.window_step_batches": (COUNTER, ()),
    "deferred.window_occupancy": (HISTOGRAM, ()),
    "deferred.window.overlap_ms": (HISTOGRAM, ()),
    "dist_curves.exchanges": (COUNTER, ("kernel", "codec")),
    "dist_curves.exchange_send_bytes": (COUNTER, ("kernel", "codec")),
    "dist_curves.sketch_folds": (COUNTER, ("family",)),
    "dist_curves.world_size": (GAUGE, ()),
    "jit.calls": (COUNTER, ("entry",)),
    "obs.labels.dropped": (COUNTER, ("instrument",)),
    "obs.cost.flops": (GAUGE, ("entry",)),
    "obs.cost.bytes_accessed": (GAUGE, ("entry",)),
    "obs.cost.hbm_bytes": (GAUGE, ("entry",)),
    "obs.cost.captures": (COUNTER, ("entry",)),
    "obs.cost.capture_errors": (COUNTER, ("entry",)),
    "ops.dist_curves.calls": (COUNTER, ("path", "family")),
    "ops.scatter.calls": (COUNTER, ("path",)),
    "ops.scatter.state_bytes_per_device": (GAUGE, ("path",)),
    "ops.topk.calls": (COUNTER, ("path",)),
    "ops.topk.merge_bytes": (COUNTER, ()),
    "ops.topk.label_bytes_per_device": (GAUGE, ("path",)),
    "recompile.traces": (COUNTER, ("entry",)),
    "resilience.checkpoint.saves": (COUNTER, ()),
    "resilience.checkpoint.restores": (COUNTER, ()),
    "resilience.checkpoint.bytes": (COUNTER, ()),
    "resilience.checkpoint.tmp_gc": (COUNTER, ()),
    "resilience.checkpoint.corrupt_skipped": (COUNTER, ("reason",)),
    "resilience.checkpoint.corrupt_quarantined": (COUNTER, ()),
    "resilience.checkpoint.fallback_restores": (COUNTER, ()),
    "sketch.folds": (COUNTER, ("kind",)),
    "sketch.folded_rows": (COUNTER, ("kind",)),
    "slo.breach": (COUNTER, ("objective", "tenant")),
    "slo.burn_rate": (GAUGE, ("objective",)),
    "toolkit.sync.rounds": (COUNTER, ()),
    "toolkit.sync.payload_bytes": (COUNTER, ()),
    "toolkit.sync.round_seconds": (HISTOGRAM, ("lane",)),
    "toolkit.sync.lane_bytes": (COUNTER, ("lane",)),
    "toolkit.sync.lane_bytes_encoded": (COUNTER, ("lane", "codec")),
    "toolkit.sync.quantize_fallbacks": (COUNTER, ("reason",)),
    "toolkit.sync.object_lane_bytes": (COUNTER, ()),
    "toolkit.sync.timeouts": (COUNTER, ("policy",)),
    "toolkit.sync.world_size": (GAUGE, ()),
}

# port entry -> JAX entry (``watched`` labels and ``count_launch`` entries)
ENTRIES: Dict[str, str] = {
    "hist": "pallas_class_counts",
    "stream_compact": "_compact_call",
    "compact_summary_rows": "compact_summary_rows",
    "topk_kernel": "pallas_topk",
    "prune_topk": "prune_topk",
    "sharded_label_topk": "ops.sharded_label_topk",
    "segment_sum": "pallas_segment_sum",
    "class_counts": "class_counts",
    "match_triple_counts": "match_triple_counts",
    "confusion_matrix_counts": "confusion_matrix_counts",
    "binary_auroc_counts_kernel": "binary_auroc_counts_kernel",
    "binary_auprc_counts_kernel": "binary_auprc_counts_kernel",
    "binary_auroc_counts_presorted_kernel": "binary_auroc_counts_presorted_kernel",
    "binary_auprc_counts_presorted_kernel": "binary_auprc_counts_presorted_kernel",
    "binary_auroc_kernel": "binary_auroc_kernel",
    "binary_auprc_kernel": "binary_auprc_kernel",
    "prc_points_kernel": "prc_points_kernel",
    "multiclass_prc_points_kernel": "multiclass_prc_points_kernel",
    "multiclass_auroc_kernel": "multiclass_auroc_kernel",
    "multiclass_auprc_kernel": "multiclass_auprc_kernel",
    "deferred.fold_pending": "deferred.fold",
    "deferred.group_fold": "deferred.group_fold",
    "deferred.window_step": "deferred.window_step",
    "dist_curves.curve_value": "dist_curves.<which>{,_q8,_q8i8}",
    "dist_curves.sharded_sketch_counts": "dist_curves.sketch_fold",
}

# the four hand kernels: their ``jit.calls`` count launches, and they carry
# cost gauges (``obs/cost.py``); ``compact_summary_rows`` reaches the
# compaction kernel and carries its cost too
KERNEL_ENTRIES = ("hist", "stream_compact", "topk_kernel", "segment_sum")
COST_ENTRIES = KERNEL_ENTRIES + ("compact_summary_rows",)

LABEL_VALUES: Dict[Tuple[str, str], Dict[str, str]] = {
    # the hand kernel for the Pallas lowering; on a CPU tensor the kernel
    # method runs its plain version, the JAX package's XLA route
    ("ops.topk.calls", "path"): {"cuda": "pallas", "torch": "pallas"},
    ("ops.topk.label_bytes_per_device", "path"): {"cuda": "pallas", "torch": "pallas"},
    ("ops.scatter.calls", "path"): {"cuda": "pallas", "torch": "xla"},
    ("ops.scatter.state_bytes_per_device", "path"): {"cuda": "pallas", "torch": "xla"},
}


def jax_value(instrument: str, key: str, value: str) -> str:
    """The JAX package's label value for the port's ``value``."""
    if key == "entry":
        return ENTRIES.get(value, value)
    return LABEL_VALUES.get((instrument, key), {}).get(value, value)
