"""One rank of the resilience test worlds, on gloo and the CPU.

JAX counterpart: ``tests/resilience/mp_chaos_worker.py`` (the kill and
straggler worlds). Each test launches the ranks of one world:

    python -m torcheval_tpu_torch.utils.test_utils.resilience_worker <scenario> <rank> <world> <port> <outdir>

``kill`` and ``delay`` (four ranks): each rank streams its shard into a
local ``MulticlassAccuracy``, completes one healthy
``sync_and_compute`` (rounds 1-2), checkpoints its local replica, streams
more and enters a second sync under ``timeout_s=TIMEOUT_S`` and
``on_failure="local"``. The chaos hooks, armed by the launcher through
``TORCHEVAL_TPU_CHAOS_*``, kill rank ``KILLED_RANK`` (``os._exit``) or make
it sleep past its budget as it enters round 3. Every rank that lives writes
``<outdir>/rank<r>.json`` and its obs snapshot ``rank<r>.obs.json``.

``sliced_ckpt`` (two ranks, a 1-D ``("slices",)`` mesh): a slice-sharded
``SlicedMetricCollection`` is saved by every rank into
``<outdir>/ckpt_rank<r>``, then restored into a fresh collection on an
equal mesh and into one whose slice dim has another size (which must raise
``"unsupported"``).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

NUM_CLASSES = 5
BATCH = 48
# the survivors' degraded-mode deadline
TIMEOUT_S = 6.0
CHAOS_EXIT_CODE = 43
KILLED_RANK = 2
# the straggler's sleep: longer than the whole second-sync budget, so its
# own deadline expires before it enters the round and its peers' collective
# really blocks
STRAGGLE_S = 12.0
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def make_shard(rank: int, phase: int):
    """``mp_chaos_worker.make_shard``: the same seeded batches."""
    rng = np.random.default_rng(1000 + 10 * phase + rank)
    scores = rng.random((BATCH, NUM_CLASSES)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, BATCH)
    return scores, labels


def run_chaos(rank: int, world: int, outdir: str) -> dict:
    import torch

    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.metrics import MulticlassAccuracy
    from torcheval_tpu_torch.metrics import toolkit
    from torcheval_tpu_torch.resilience import save
    from torcheval_tpu_torch.utils.test_utils.obs_counts import count, rounds

    obs.enable()
    results = {"rank": rank}
    acc = MulticlassAccuracy(num_classes=NUM_CLASSES, device="cpu")
    s0, l0 = make_shard(rank, phase=0)
    acc.update(torch.from_numpy(s0), torch.from_numpy(l0))
    # sync 1 (rounds 1-2): every rank alive, the global value
    r = toolkit.sync_and_compute(acc, recipient_rank="all", timeout_s=120.0, on_failure="local")
    results["sync1"] = float(r)
    # the pre-fault checkpoint of the LOCAL replica, one directory a rank
    save(acc, os.path.join(outdir, f"ckpt_rank{rank}"))
    results["local_compute_at_ckpt"] = float(acc.compute())
    # after the checkpoint: these batches are not in it
    s1, l1 = make_shard(rank, phase=1)
    acc.update(torch.from_numpy(s1), torch.from_numpy(l1))
    results["local_compute_post"] = float(acc.compute())
    # sync 2 (rounds 3-4): chaos acts on KILLED_RANK entering round 3
    t0 = time.monotonic()
    r = toolkit.sync_and_compute(acc, recipient_rank="all", timeout_s=TIMEOUT_S, on_failure="local")
    results["sync2"] = float(r)
    results["sync2_elapsed_s"] = time.monotonic() - t0
    results["failures"] = int(count("toolkit.sync.timeouts"))
    results["rounds"] = rounds()
    with open(os.path.join(outdir, f"rank{rank}.obs.json"), "w") as f:
        json.dump(obs.snapshot(), f, indent=2)
    return results


def run_sliced_ckpt(rank: int, world: int, outdir: str) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from torcheval_tpu_torch.resilience import CheckpointError, restore, save
    from torcheval_tpu_torch.utils.test_utils.sharded_worker import _feed, _sliced, _tile_rows, _values, sliced_batches

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("slices",))
    col = _feed(_sliced(True, mesh, 64), sliced_batches(300, seed=5))
    path = save(col, os.path.join(outdir, f"ckpt_rank{rank}"))
    res = {"saved": _values(col), "capacity": col.slice_table.capacity}
    with open(os.path.join(path, "manifest.json")) as f:
        res["sharded_mesh"] = [e.get("sharded_mesh") for e in json.load(f)["entries"]]
    equal = restore(_sliced(True, mesh), path)
    res["equal_mesh"] = _values(equal)
    res["equal_tile_rows"] = _tile_rows(equal)
    extra = sliced_batches(40, n_batches=1, seed=6)
    res["equal_streamed"] = _values(_feed(equal, extra))
    res["saved_streamed"] = _values(_feed(col, extra))
    other = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "slices"))
    try:
        restore(_sliced(True, other), path)
        res["unequal"] = "restored"
    except CheckpointError as e:
        res["unequal"] = e.reason
    return res


SCENARIOS = {"kill": run_chaos, "delay": run_chaos, "sliced_ckpt": run_sliced_ckpt}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch(scenario: str, outdir: str, world: int, timeout_s: float, env_extra=None,
           module: str = __name__):
    """Start the ``world`` ranks of ``scenario`` (``python -m <module>
    scenario R world PORT OUTDIR``) and wait for them (all are killed at
    ``timeout_s``). Returns ``(returncodes, outputs, results)``,
    ``results[r]`` being ``None`` for a rank that wrote none (the killed
    one). The exit codes are the caller's to check."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(name, None)
    env.update(env_extra or {})
    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", module, scenario, str(r), str(world), port, outdir],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout_s
    outs = []
    for p in procs:
        try:
            out = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = p.communicate()[0]
        outs.append(out.decode(errors="replace"))
    results = []
    for r in range(world):
        path = os.path.join(outdir, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                results.append(json.load(f))
        else:
            results.append(None)
    return [p.returncode for p in procs], outs, results


def main() -> None:
    scenario, rank, world, port, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    os.environ.update(
        MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(world), RANK=str(rank)
    )
    from torcheval_tpu_torch.parallel import init_from_env

    got = init_from_env(device="cpu")
    assert got == (rank, world), got
    res = SCENARIOS[scenario](rank, world, outdir)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
        f.flush()
        os.fsync(f.fileno())
    sys.stdout.flush()
    sys.stderr.flush()
    if scenario == "sliced_ckpt":
        from torcheval_tpu_torch.utils.test_utils.sharded_worker import leave_world

        leave_world()
    # after a degraded sync a peer may be dead and a round thread blocked:
    # leave without the interpreter's teardown (destroying the group could
    # wait on a world that no longer exists)
    os._exit(0)


if __name__ == "__main__":
    main()
