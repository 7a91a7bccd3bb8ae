"""One rank of the quantized-sync test worlds, on gloo and the CPU.

JAX counterpart: ``tests/metrics/test_sync_quantized.py``, which drives the
JAX toolkit's quantized lanes over a simulated wire of threads. The port
runs one process per rank, so its test module launches a world of these
workers (2 and 4 ranks):

    python -m torcheval_tpu_torch.utils.test_utils.quant_sync_worker sync <rank> <world> <port> <outdir>

Each scenario syncs the same per-rank replicas with ``quantize`` off and on
through the real two-round exchange and records the synced states, the
rounds and the payload bytes of the second round. Each process writes
``<outdir>/rank<r>.json``. The data helpers are numpy only and
deterministic in the rank, so the test rebuilds every exact reference.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

N = 4096
# the four states' raw payload bytes: two int64 sums, an int32 max and a
# float32 sum
RAW_BYTES = N * (8 + 8 + 4 + 4)
CAL_TASKS = 256
CM_CLASSES = 50
SKETCH_ROWS = 3000


def replica_arrays(rank: int, fscale: float = 10.0):
    """The ``BigState`` update of ``rank``: ``counts``, ``hits``, ``peak``,
    ``fsum`` (the JAX test's ``make_replica``)."""
    rng = np.random.default_rng(100 + rank)
    return (
        rng.integers(0, 200, N),
        rng.integers(0, 50, N),
        rng.integers(0, 1000, N),
        (rng.random(N) * fscale).astype(np.float32),
    )


def collection_arrays(rank: int):
    """``(labels, preds)`` for the confusion matrix, ``(probs, clicks,
    weights)`` for the calibration and ``(scores, targets)`` for the
    sketch, of ``rank``."""
    rng = np.random.default_rng(300 + rank)
    labels = rng.integers(0, CM_CLASSES, 2000)
    preds = np.where(rng.random(2000) < 0.7, labels, rng.integers(0, CM_CLASSES, 2000))
    probs = rng.random((CAL_TASKS, 40)).astype(np.float32)
    clicks = (rng.random((CAL_TASKS, 40)) < 0.2).astype(np.float32)
    weights = (rng.random((CAL_TASKS, 40)) + 0.5).astype(np.float32)
    scores = rng.random(SKETCH_ROWS).astype(np.float32)
    targets = (rng.random(SKETCH_ROWS) < 0.4).astype(np.float32)
    return (labels, preds), (probs, clicks, weights), (scores, targets)


def _big_state_class():
    import torch

    from torcheval_tpu_torch.metrics.metric import Metric
    from torcheval_tpu_torch.metrics.state import Reduction

    class BigState(Metric):
        """Integer lanes dominate: two int64 SUM counts, an int32 MAX and a
        float32 SUM tail."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self._add_state("counts", torch.zeros(N, dtype=torch.int64), reduction=Reduction.SUM)
            self._add_state("hits", torch.zeros(N, dtype=torch.int64), reduction=Reduction.SUM)
            self._add_state("peak", torch.zeros(N, dtype=torch.int32), reduction=Reduction.MAX)
            self._add_state("fsum", torch.zeros(N, dtype=torch.float32), reduction=Reduction.SUM)

        def update(self, c, h, p, f):
            self.counts = self.counts + torch.as_tensor(c, dtype=torch.int64)
            self.hits = self.hits + torch.as_tensor(h, dtype=torch.int64)
            self.peak = torch.maximum(self.peak, torch.as_tensor(p, dtype=torch.int32))
            self.fsum = self.fsum + torch.as_tensor(f)
            return self

        def compute(self):
            return self.counts.sum()

        def merge_state(self, metrics):
            for o in metrics:
                self.counts = self.counts + o.counts
                self.hits = self.hits + o.hits
                self.peak = torch.maximum(self.peak, o.peak)
                self.fsum = self.fsum + o.fsum
            return self

    return BigState


def run_sync(rank: int, world: int, outdir: str) -> dict:
    import torch

    from torcheval_tpu_torch.metrics import (
        BinaryAUROC,
        MulticlassConfusionMatrix,
        Sum,
        WeightedCalibration,
        WindowedClickThroughRate,
        toolkit,
    )
    from torcheval_tpu_torch.utils.test_utils.obs_counts import count, rounds

    BigState = _big_state_class()

    def replica(fscale=10.0, bad=False):
        m = BigState(device="cpu").update(*replica_arrays(rank, fscale))
        if bad:
            f = np.zeros(N, np.float32)
            f[rank] = np.inf if rank % 2 else np.nan
            m.update(np.zeros(N, np.int64), np.zeros(N, np.int64), np.zeros(N, np.int64), f)
        return m

    def synced(m, quantize):
        r0, sent = rounds(), count("toolkit.sync.payload_bytes")
        fallbacks = count("toolkit.sync.quantize_fallbacks")
        s = toolkit.get_synced_metric(m, recipient_rank="all", quantize=quantize)
        return {
            "counts": s.counts.tolist(), "hits": s.hits.tolist(), "peak": s.peak.tolist(),
            "fsum": [float(v) for v in s.fsum.tolist()],
            "dtypes": [str(getattr(s, n).dtype) for n in ("counts", "hits", "peak", "fsum")],
            "rounds": rounds() - r0,
            # the payload round's bytes: all sent bytes less the descriptor
            # round's (five rows of nine int32)
            "payload_bytes": int(count("toolkit.sync.payload_bytes") - sent) - 5 * 9 * 4,
            "fallbacks": int(count("toolkit.sync.quantize_fallbacks") - fallbacks),
        }

    res = {"raw": synced(replica(), False), "quantized": synced(replica(), True),
           "mixed": synced(replica(), rank == 0), "nonfinite": synced(replica(bad=True), True)}
    os.environ["TORCHEVAL_TPU_SYNC_QUANTIZE"] = "1"
    res["env_on"] = synced(replica(), None)
    res["env_on_opt_out"] = synced(replica(), False)
    os.environ["TORCHEVAL_TPU_SYNC_QUANTIZE"] = "int8"  # any mode turns the lanes on
    res["env_int8"] = synced(replica(), None)
    del os.environ["TORCHEVAL_TPU_SYNC_QUANTIZE"]

    s = Sum(device="cpu").update(torch.tensor([float(rank + 1), 2.0 * (rank + 1)]))
    res["small_sum"] = float(toolkit.sync_and_compute(s, recipient_rank="all", quantize=True))

    # a collection over the three codecs: narrow (the confusion matrix), q8
    # (the calibration's 256-task sums), bucket (the sketch's histograms);
    # a windowed member rides the WINDOW lane beside them
    (labels, preds), (probs, clicks, weights), (scores, targets) = collection_arrays(rank)
    res["collection"] = {}
    for quantize in (False, True):
        members = {
            "cm": MulticlassConfusionMatrix(CM_CLASSES, device="cpu").update(
                torch.from_numpy(preds), torch.from_numpy(labels)),
            "cal": WeightedCalibration(num_tasks=CAL_TASKS, device="cpu").update(
                torch.from_numpy(probs), torch.from_numpy(clicks), torch.from_numpy(weights)),
            "sketch": BinaryAUROC(approx=True, compaction_threshold=1000, device="cpu").update(
                torch.from_numpy(scores), torch.from_numpy(targets)),
            "wctr": WindowedClickThroughRate(num_tasks=2, window_size=3, device="cpu").update(
                torch.from_numpy(clicks[:2]), torch.from_numpy(weights[:2])),
        }
        r0, sent = rounds(), count("toolkit.sync.payload_bytes")
        out = toolkit.sync_and_compute_collection(members, recipient_rank="all", quantize=quantize)
        n_rounds, sent = rounds() - r0, int(count("toolkit.sync.payload_bytes") - sent)
        sketch = toolkit.get_synced_metric(members["sketch"], recipient_rank="all", quantize=quantize)
        res["collection"][str(quantize)] = {
            "cm": out["cm"].tolist(), "cal": out["cal"].tolist(),
            "cal_states": [toolkit.get_synced_metric(members["cal"], recipient_rank="all",
                                                     quantize=quantize).state_dict()[k].tolist()
                           for k in ("weighted_input_sum", "weighted_label_sum")],
            "sketch": float(out["sketch"]),
            "sketch_counts": [sketch.sketch_tp.tolist(), sketch.sketch_fp.tolist()],
            "wctr": [v.tolist() for v in out["wctr"]],
            "rounds": n_rounds,
            "bytes": sent,
        }
    return res


SCENARIOS = {"sync": run_sync}


def launch_world(outdir: str, timeout_s: float, world: int) -> list:
    """The ``world`` ranks of the sync scenario
    (``sharded_worker.launch_world``)."""
    from torcheval_tpu_torch.utils.test_utils.sharded_worker import launch_world as launch

    return launch("sync", outdir, timeout_s, world, module=__name__)


def main() -> None:
    scenario, rank, world, port, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    os.environ.update(
        MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(world), RANK=str(rank)
    )
    os.environ.pop("TORCHEVAL_TPU_SYNC_QUANTIZE", None)
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.parallel import init_from_env
    from torcheval_tpu_torch.utils.test_utils.sharded_worker import leave_world

    obs.enable()  # the rounds, bytes and fallbacks are its counters
    got = init_from_env(device="cpu")
    assert got == (rank, world), got
    res = SCENARIOS[scenario](rank, world, outdir)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    leave_world()


if __name__ == "__main__":
    main()
