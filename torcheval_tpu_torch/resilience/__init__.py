"""``torcheval_tpu_torch.resilience``: failure handling for the eval stack.

JAX counterpart: ``torcheval_tpu/resilience/__init__.py``, with the same
exports. Three legs:

* **Atomic checkpoint/restore** (``snapshot.py``): ``save``/``restore`` for
  any state holder (Metric / MetricCollection / SlicedMetricCollection /
  ShardedEvaluator / metric dict): temp-then-rename publishes, SHA-256
  content checksums, the sync wire's schema digest, ``keep_last``
  rotation, lineage fallback past corrupt generations, and structured
  :class:`CheckpointError` rejection of corrupt or mismatched payloads.
  The on-disk format is the JAX package's, so checkpoints cross packages.
* **Sync deadlines + graceful degradation** (``metrics/toolkit.py``): every
  explicit sync API takes ``timeout_s=`` and ``on_failure="raise"|"local"``
  (``"local"`` returns the local, unsynced result, so a dead rank degrades
  the report instead of hanging the job).
* **Fault injection** (``chaos.py``): env-gated test-only hooks that kill or
  delay a chosen rank at a chosen sync round, or flip a byte of a just
  published checkpoint.

Obs counters (``torcheval_tpu_torch.obs``):
``resilience.checkpoint.{saves,restores,bytes}`` and the lineage counters
listed in ``snapshot.py``.
"""

from torcheval_tpu_torch.resilience.snapshot import (
    CheckpointError,
    discover_checkpoints,
    latest_checkpoint,
    list_checkpoints,
    quarantine_checkpoint,
    read_extra,
    restore,
    restore_latest_valid,
    save,
)

__all__ = [
    "CheckpointError",
    "SyncError",
    "SyncRoundError",
    "SyncTimeoutError",
    "discover_checkpoints",
    "latest_checkpoint",
    "list_checkpoints",
    "quarantine_checkpoint",
    "read_extra",
    "restore",
    "restore_latest_valid",
    "save",
]

_TOOLKIT_REEXPORTS = ("SyncError", "SyncRoundError", "SyncTimeoutError")


def __getattr__(name: str):
    # lazy re-export (PEP 562): the sync failure types are DEFINED in
    # metrics/toolkit.py (next to the sync APIs that raise them) and only
    # surfaced here; importing toolkit eagerly would cycle, because toolkit
    # itself imports resilience.chaos for the fault-injection funnel.
    if name in _TOOLKIT_REEXPORTS:
        from torcheval_tpu_torch.metrics import toolkit

        return getattr(toolkit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
