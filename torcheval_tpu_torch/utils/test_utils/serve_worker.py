"""One rank of the serve fault-containment worlds, on gloo and the CPU.

JAX counterpart: ``tests/serve/mp_serve_worker.py``. Each of four ranks
joins a gloo world and runs ONE ``EvalDaemon(device="cpu")`` serving three
tenants:

* ``alice``, the healthy tenant, whose values come through every fault
  bit for bit, locally and over the two sync legs;
* ``bob``, the poison victim: on ``POISON_RANK`` chaos turns bob's second
  batch to all-NaN at the queue boundary, and ``nan_policy="reject"``
  quarantines him there;
* ``carol``, evicted mid-stream (a ``resilience.save`` checkpoint),
  re-attached with ``resume="require"`` and streamed to the end.

Then two syncs through the daemon's worker: A with every rank alive (the
global value), and B during which chaos kills or delays ``FAULT_RANK`` as
it enters round 3; the others degrade to their LOCAL values within
``TIMEOUT_S``. A rank arms its own chaos before anything reads it:

    python -m torcheval_tpu_torch.utils.test_utils.serve_worker {kill,delay} <rank> <world> <port> <outdir>

Each rank that lives writes ``<outdir>/rank<r>.json``, its obs snapshot
``rank<r>.obs.json`` and its daemon's health ``rank<r>.health.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from torcheval_tpu_torch.utils.test_utils.resilience_worker import launch as _launch

NUM_CLASSES = 5
BATCH = 48
PHASE0_BATCHES = 3
PHASE1_BATCHES = 2
# the survivors' deadline in sync B, and the straggler's sleep past it
TIMEOUT_S = 6.0
STRAGGLE_S = 12.0
CHAOS_EXIT_CODE = 43
POISON_RANK = 1
FAULT_RANK = 2
TENANTS = ("alice", "bob", "carol")


def make_shard(rank: int, tenant: str, phase: int, batch: int):
    """``mp_serve_worker.make_shard``: the same seeded batches."""
    seed = 10_000 * (TENANTS.index(tenant) + 1) + 100 * phase + 10 * batch + rank
    rng = np.random.default_rng(seed)
    scores = rng.random((BATCH, NUM_CLASSES)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, BATCH)
    return scores, labels


def tenant_stream(rank: int, tenant: str, phases=(0,)):
    out = []
    for phase in phases:
        n = PHASE0_BATCHES if phase == 0 else PHASE1_BATCHES
        out.extend(make_shard(rank, tenant, phase, b) for b in range(n))
    return out


def _arm_chaos(scenario: str, rank: int) -> None:
    """This rank's chaos, set before any chaos hook reads the env."""
    for k in list(os.environ):
        if k.startswith("TORCHEVAL_TPU_CHAOS"):
            del os.environ[k]
    if rank == POISON_RANK:
        os.environ.update(
            TORCHEVAL_TPU_CHAOS="1",
            TORCHEVAL_TPU_CHAOS_ACTION="poison",
            TORCHEVAL_TPU_CHAOS_TENANT="bob",
            TORCHEVAL_TPU_CHAOS_STEP="2",
            TORCHEVAL_TPU_CHAOS_POISON="nan",
        )
    elif rank == FAULT_RANK:
        os.environ.update(
            TORCHEVAL_TPU_CHAOS="1",
            TORCHEVAL_TPU_CHAOS_ACTION=scenario,
            TORCHEVAL_TPU_CHAOS_RANK=str(FAULT_RANK),
            TORCHEVAL_TPU_CHAOS_ROUND="3",
            TORCHEVAL_TPU_CHAOS_DELAY_S=str(STRAGGLE_S),
            TORCHEVAL_TPU_CHAOS_EXIT_CODE=str(CHAOS_EXIT_CODE),
        )
    from torcheval_tpu_torch.resilience import chaos

    chaos.reset_for_tests()


def run(rank: int, outdir: str) -> dict:
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.metrics import MulticlassAccuracy
    from torcheval_tpu_torch.serve import EvalDaemon, TenantQuarantinedError

    def acc():
        return {"acc": MulticlassAccuracy(num_classes=NUM_CLASSES, device="cpu")}

    obs.enable()
    results = {"rank": rank}
    daemon = EvalDaemon(device="cpu", evict_dir=os.path.join(outdir, f"evict_rank{rank}")).start()
    handles = {
        t: daemon.attach(t, acc(), nan_policy="reject" if t == "bob" else "propagate") for t in TENANTS
    }
    for b in range(PHASE0_BATCHES):
        for t in TENANTS:
            try:
                handles[t].submit(*make_shard(rank, t, 0, b))
            except TenantQuarantinedError as e:
                results[f"{t}_submit_error"] = e.reason
    results["alice_phase0"] = float(handles["alice"].compute(timeout=120)["acc"])
    try:
        results["bob_phase0"] = float(handles["bob"].compute(timeout=120)["acc"])
    except TenantQuarantinedError as e:
        results["bob_quarantined"] = {
            "reason": e.reason,
            "tenant": e.tenant,
            "cause": type(e.__cause__).__name__ if e.__cause__ else None,
        }
    ckpt = daemon.evict("carol", timeout=120)
    results["carol_ckpt_exists"] = os.path.isdir(ckpt)
    carol = daemon.attach("carol", acc(), resume="require")
    for b in range(PHASE1_BATCHES):
        carol.submit(*make_shard(rank, "carol", 1, b))
    results["carol_resumed"] = float(carol.compute(timeout=120)["acc"])
    sync_a = handles["alice"].sync_compute(timeout_s=60.0, on_failure="local", timeout=180)
    results["alice_syncA"] = float(sync_a["acc"])
    for b in range(PHASE1_BATCHES):
        handles["alice"].submit(*make_shard(rank, "alice", 1, b))
    t0 = time.monotonic()
    sync_b = handles["alice"].sync_compute(timeout_s=TIMEOUT_S, on_failure="local", timeout=240)
    results["alice_syncB"] = float(sync_b["acc"])
    results["syncB_elapsed_s"] = time.monotonic() - t0
    results["alice_local_post"] = float(handles["alice"].compute(timeout=120)["acc"])
    snap = obs.snapshot()
    results["timeouts_local"] = snap["counters"].get("toolkit.sync.timeouts{policy=local}", 0.0)
    with open(os.path.join(outdir, f"rank{rank}.obs.json"), "w") as f:
        json.dump(snap, f, indent=2)
    with open(os.path.join(outdir, f"rank{rank}.health.json"), "w") as f:
        json.dump(daemon.health(), f, indent=2)
    return results


def launch(scenario: str, outdir: str, timeout_s: float, world: int = 4):
    """Start the ``world`` ranks of ``scenario`` and wait for them (all
    killed at ``timeout_s``): ``(returncodes, outputs, results)``."""
    return _launch(scenario, outdir, world, timeout_s, module=__name__)


def main() -> None:
    scenario, rank, world, port, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    _arm_chaos(scenario, rank)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(world), RANK=str(rank))
    from torcheval_tpu_torch.parallel import init_from_env

    assert init_from_env(device="cpu") == (rank, world)
    res = run(rank, outdir)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
        f.flush()
        os.fsync(f.fileno())
    sys.stdout.flush()
    sys.stderr.flush()
    # a peer may be dead and a round thread blocked: leave without the
    # interpreter's teardown
    os._exit(0)


if __name__ == "__main__":
    main()
