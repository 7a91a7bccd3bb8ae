"""One rank of the obs test worlds (``obs.sync_snapshot``,
``MetricsServer``), on gloo and the CPU.

JAX counterpart: ``tests/obs/mp_obs_worker.py``. The port runs one process
per rank; its test module launches the ranks:

    python -m torcheval_tpu_torch.utils.test_utils.obs_worker <scenario> <rank> <world> <port> <outdir>

``snapshot``: every rank records its own counters, a gauge, a histogram and
a span, syncs a ``Sum``, then takes its local snapshot and
``obs.sync_snapshot(timeout_s=30)``; rank 0 also serves ``GET /metrics``
and ``GET /health`` from a ``MetricsServer`` on an ephemeral port.
``dead``: the last rank leaves before the round, and rank 0's
``sync_snapshot(timeout_s=5, on_failure="local")`` degrades to its local
view. Each rank writes ``<outdir>/rank<r>.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time
import urllib.request


def _record(rank: int) -> None:
    """Rank-dependent instruments of every kind."""
    from torcheval_tpu_torch import obs

    obs.counter("deferred.folds", rank + 1, entry="fold", path="stacked")
    obs.counter("sketch.folded_rows", 10.0 * (rank + 1), kind="score")
    obs.gauge("dist_curves.world_size", 2 + rank)
    for v in (0.001 * (rank + 1), 0.5, 2.0):
        obs.histo("toolkit.sync.round_seconds", v, lane="typed")
    obs.default_registry.observe_span("collection.update", 0.01 * (rank + 1))


def run_snapshot(rank: int, world: int) -> dict:
    import torch

    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.metrics import Sum, toolkit
    from torcheval_tpu_torch.utils.test_utils.obs_counts import count, rounds

    _record(rank)
    synced = toolkit.sync_and_compute(Sum(device="cpu").update(torch.tensor([rank + 1.0])),
                                      recipient_rank="all")
    local = obs.snapshot()
    r0, b0 = rounds(), count("toolkit.sync.payload_bytes")
    merged = obs.sync_snapshot(timeout_s=30)
    res = {
        "synced": float(synced), "local": local, "merged": merged,
        "extra_rounds": rounds() - r0,
        "buffer_bytes": int(count("toolkit.sync.payload_bytes") - b0),
    }
    if rank == 0:
        srv = obs.MetricsServer(port=0).start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                body = r.read()
            res["metrics_equal"] = body == obs.prometheus_text().encode()
            with urllib.request.urlopen(base + "/health", timeout=30) as r:
                res["health"] = json.loads(r.read())
        finally:
            srv.close()
    return res


def run_dead(rank: int, world: int) -> dict:
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.utils.test_utils.obs_counts import count

    _record(rank)
    if rank == world - 1:
        os._exit(0)  # leaves before the round
    t0 = time.monotonic()
    merged = obs.sync_snapshot(timeout_s=5, on_failure="local")
    return {"merged": merged, "seconds": time.monotonic() - t0,
            "timeouts": count("toolkit.sync.timeouts", policy="local")}


SCENARIOS = {"snapshot": run_snapshot, "dead": run_dead}


def launch(scenario: str, outdir: str, world: int, timeout_s: float):
    """Run the ``world`` ranks of ``scenario`` (all killed at
    ``timeout_s``); returns ``(returncodes, outputs, results)``, ``None``
    for a rank that wrote no result."""
    from torcheval_tpu_torch.utils.test_utils.resilience_worker import launch as launch_ranks

    return launch_ranks(scenario, outdir, world, timeout_s, module=__name__)


def main() -> None:
    scenario, rank, world, port, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    os.environ.update(
        MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(world), RANK=str(rank)
    )
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.parallel import init_from_env

    obs.enable()
    got = init_from_env(device="cpu")
    assert got == (rank, world), got
    res = SCENARIOS[scenario](rank, world)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f, default=str)
        f.flush()
        os.fsync(f.fileno())
    sys.stdout.flush()
    sys.stderr.flush()
    # a degraded round may leave a thread blocked on the departed peer:
    # leave without the interpreter's teardown
    os._exit(0)


if __name__ == "__main__":
    main()
