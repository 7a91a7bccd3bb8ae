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

The same module runs the router drills' processes (JAX counterparts:
``tests/serve/mp_cluster_host.py`` and the JAX restart drill's router process, ``tests/serve/mp_router_*.py``):

    python -m torcheval_tpu_torch.utils.test_utils.serve_worker host <outdir> <tag> <ckpt_root>
    python -m torcheval_tpu_torch.utils.test_utils.serve_worker router <outdir> <journal_dir> <ep1,ep2,...>

A ``host`` is one ``EvalDaemon(device="cpu")`` + ``EvalServer`` on the
shared checkpoint root; it publishes its port atomically
(``<tag>.port``) and parks until ``<tag>.stop`` appears or chaos (armed
through the environment :class:`Drill` gives it) kills it. The
``router`` is the disposable journaled router of the restart drill: it
attaches ``solo`` and a ``fan`` tenant split by 2, streams
``FIRST_ROUTER_BATCHES`` batches through both, flushes, publishes
``first_router.state.json`` and drains ``solo``'s host, inside which
``router_kill`` chaos ends it. :class:`Drill` starts these processes,
polls for their ports, and stops or kills every one of them.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

import subprocess
import zlib

from torcheval_tpu_torch.utils.test_utils.resilience_worker import ROOT
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


# --- the router drills -------------------------------------------------------

DRILL_CLASSES = 5
DRILL_BATCH = 32
DRILL_SPEC = {"acc": ["MulticlassAccuracy", {"num_classes": DRILL_CLASSES}]}
FIRST_ROUTER_BATCHES = 6


def drill_batch(tenant: str, idx: int):
    """the JAX restart drill's ``make_batch``: crc32 of the tenant, never
    ``hash()``, which Python salts per process."""
    seed = 1000 * (zlib.crc32(tenant.encode()) % 97) + idx
    rng = np.random.default_rng(seed)
    return (rng.random((DRILL_BATCH, DRILL_CLASSES)).astype(np.float32),
            rng.integers(0, DRILL_CLASSES, DRILL_BATCH))


def drill_oracle(tenant: str, n: int) -> float:
    from torcheval_tpu_torch.metrics import MulticlassAccuracy

    m = MulticlassAccuracy(num_classes=DRILL_CLASSES, device="cpu")
    for i in range(n):
        m.update(*drill_batch(tenant, i))
    return float(m.compute())


def _publish(path: str, text: str) -> None:
    with open(path + ".tmp", "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)  # readers never see a partial file


def run_host(outdir: str, tag: str, ckpt_root: str) -> None:
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.serve import EvalDaemon, EvalServer

    obs.enable()
    daemon = EvalDaemon(device="cpu", evict_dir=ckpt_root).start()
    server = EvalServer(daemon)  # port 0
    os.makedirs(outdir, exist_ok=True)
    _publish(os.path.join(outdir, f"{tag}.port"), str(server.address[1]))
    stop_path = os.path.join(outdir, f"{tag}.stop")
    while not os.path.exists(stop_path):
        time.sleep(0.05)
    server.close()
    daemon.stop()


def run_router(outdir: str, journal_dir: str, endpoints: str) -> None:
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.serve import EvalRouter

    obs.enable()
    router = EvalRouter(endpoints.split(","), journal_dir=journal_dir, device="cpu",
                        request_timeout_s=30.0, connect_timeout_s=10.0, max_attempts=2,
                        backoff_base_s=0.05)
    router.attach("solo", DRILL_SPEC)
    router.attach("fan", DRILL_SPEC)
    router.split_tenant("fan", replicas=2)
    for i in range(FIRST_ROUTER_BATCHES):
        router.submit("solo", *drill_batch("solo", i))
        router.submit("fan", *drill_batch("fan", i))
    router.flush("solo")
    router.flush("fan")
    placement = router.placement()
    state = {"placement": placement, "submitted": FIRST_ROUTER_BATCHES, "victim": placement["solo"]}
    _publish(os.path.join(outdir, "first_router.state.json"), json.dumps(state, indent=2))
    router.drain(state["victim"])  # router_kill at migrate_exported fires in here


class Drill:
    """The processes of one drill world, each logging to
    ``<outdir>/<tag>.log``. :meth:`host` waits for the port by polling to
    ``port_timeout_s``; :meth:`close` asks every host to stop, waits for
    each up to ``join_timeout_s`` and kills what is left (call it from
    ``finally``)."""

    def __init__(self, outdir: str, ckpt_root: str, *, port_timeout_s: float = 120.0,
                 join_timeout_s: float = 30.0) -> None:
        self.outdir, self.ckpt_root = outdir, ckpt_root
        self.port_timeout_s, self.join_timeout_s = port_timeout_s, join_timeout_s
        self.procs: dict = {}
        self._logs: list = []
        os.makedirs(ckpt_root, exist_ok=True)

    def _env(self, chaos=None) -> dict:
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        env["OMP_NUM_THREADS"] = "1"
        for k in list(env):
            if k.startswith("TORCHEVAL_TPU_CHAOS"):
                del env[k]
        env.update(chaos or {})
        return env

    def spawn(self, tag: str, args, chaos=None) -> subprocess.Popen:
        log = open(os.path.join(self.outdir, f"{tag}.log"), "wb")
        self._logs.append(log)
        proc = subprocess.Popen([sys.executable, "-m", __name__, *args], env=self._env(chaos),
                                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        self.procs[tag] = proc
        return proc

    def host(self, tag: str, chaos=None) -> str:
        """Start host ``tag`` and return its endpoint once it is up."""
        proc = self.spawn(tag, ["host", self.outdir, tag, self.ckpt_root], chaos)
        path = os.path.join(self.outdir, f"{tag}.port")
        deadline = time.monotonic() + self.port_timeout_s
        while not os.path.exists(path):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError(f"host {tag} never published its port: {self.log(tag)[-2000:]}")
            time.sleep(0.05)
        with open(path) as f:
            return f"127.0.0.1:{int(f.read())}"

    def log(self, tag: str) -> str:
        with open(os.path.join(self.outdir, f"{tag}.log"), "rb") as f:
            return f.read().decode(errors="replace")

    def join(self, tag: str, timeout_s: float) -> int:
        try:
            return self.procs[tag].wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.procs[tag].kill()
            return self.procs[tag].wait()

    def close(self) -> dict:
        """Stop every process; their exit codes by tag."""
        for tag in self.procs:
            with open(os.path.join(self.outdir, f"{tag}.stop"), "w"):
                pass
        codes = {tag: self.join(tag, self.join_timeout_s) for tag in self.procs}
        for log in self._logs:
            log.close()
        return codes


def main() -> None:
    if sys.argv[1] == "host":
        run_host(*sys.argv[2:5])
        os._exit(0)
    if sys.argv[1] == "router":
        run_router(*sys.argv[2:5])
        os._exit(99)  # unreachable when the drill armed router_kill
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
