"""One rank of a multi-process sync test world, on gloo and the CPU.

JAX counterpart: ``tests/metrics/mp_sync_worker.py``, the worker of the JAX
package's 4-process sync tests. Each process joins a ``torch.distributed``
world through ``parallel.init_from_env`` (fed ``torchrun``-style
environment variables), streams its rank's shard into local metric
replicas, drives the explicit sync paths (``metrics/toolkit.py``), the
sharded class counts, ``ShardedEvaluator`` and the distributed example, and
writes every scenario's results to ``<outdir>/rank<r>.json``. Run one
process per rank:

    python -m torcheval_tpu_torch.utils.test_utils.sync_worker <rank> <world> <port> <outdir>

The data helpers below are deterministic in the rank and use numpy only,
so that a test can rebuild the single-stream input for its references.
"""

from __future__ import annotations

import json
import os
import sys
from collections import deque

import numpy as np

NUM_CLASSES = 5
ACC_BATCH = 64
# uneven AUROC shards with one empty rank (rank 2)
AUROC_SIZES = [37, 11, 0, 52]
WINDOW_MAXLEN = 6
HIST_CLASSES = 7
HIST_PER_RANK = 1000
# uneven global batches over 4 ranks; the last leaves rank 3 an empty block
EVAL_BATCHES = [64, 64, 64, 50, 3]
SLICED_POOL = 9
SLICED_N = 181
SUBGROUP = (1, 3)


def make_acc_shard(rank: int):
    rng = np.random.default_rng(100 + rank)
    scores = rng.random((ACC_BATCH, NUM_CLASSES)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, ACC_BATCH)
    return scores, labels


def make_auroc_shard(rank: int):
    n = AUROC_SIZES[rank]
    rng = np.random.default_rng(200 + rank)
    scores = rng.random(n).astype(np.float32)
    targets = (rng.random(n) < 0.4).astype(np.float32)
    return scores, targets


def make_dict_updates(rank: int):
    # overlapping and rank-unique keys
    return [("shared", float(rank + 1)), (f"rank{rank}", 10.0 * (rank + 1))]


def make_window_rows(rank: int):
    """Two (2,) rows per rank, the second row's value marking the rank."""
    return [np.asarray([rank, i], np.float32) for i in range(2)]


def make_hist_labels(rank: int):
    rng = np.random.default_rng(700 + rank)
    return rng.integers(-2, HIST_CLASSES + 2, HIST_PER_RANK).astype(np.int64)


def make_eval_batches():
    """Global batches of (scores (n, 5), labels (n,)) for the evaluator."""
    rng = np.random.default_rng(800)
    return [
        (rng.random((n, NUM_CLASSES)).astype(np.float32), rng.integers(0, NUM_CLASSES, n))
        for n in EVAL_BATCHES
    ]


def make_sliced_shard(rank: int):
    """Ragged cohort populations: overlapping id pools, rank 2 empty."""
    if rank == 2:
        return []
    rng = np.random.default_rng(600 + rank)
    pool_ids = (np.arange(SLICED_POOL) + rank * 4) * 97 - 13
    out = []
    for _ in range(2):
        ids = rng.choice(pool_ids, SLICED_N)
        scores = rng.random(SLICED_N).astype(np.float32)
        targets = (rng.random(SLICED_N) < 0.5).astype(np.float32)
        out.append((ids, scores, targets))
    return out


def _f1s(device):
    from torcheval_tpu_torch.metrics import MulticlassF1Score

    return {
        avg or "none": MulticlassF1Score(num_classes=NUM_CLASSES, average=avg, device=device)
        for avg in ("micro", "macro", "weighted", None)
    }


def _list(x):
    arr = np.asarray(x.cpu() if hasattr(x, "cpu") else x, dtype=np.float64)
    return arr.tolist()


def _window_metric(device):
    """A metric whose one state is a WINDOW deque of per-update rows."""
    import torch

    from torcheval_tpu_torch.metrics.metric import Metric
    from torcheval_tpu_torch.metrics.state import Reduction

    class WindowRows(Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self._add_state("rows", deque(maxlen=WINDOW_MAXLEN), reduction=Reduction.WINDOW)

        def update(self, row):
            self.rows.append(self._input(row))
            return self

        def compute(self):
            return torch.stack(list(self.rows)) if self.rows else torch.zeros((0, 2))

        def merge_state(self, metrics):
            for m in metrics:
                self.rows.extend(r.to(self.device) for r in m.rows)
            return self

    return WindowRows(device=device)


def _rounds(fn):
    """``(result, collective rounds, payload bytes)`` of one call."""
    from torcheval_tpu_torch.utils.test_utils.obs_counts import count, rounds

    r0, b0 = rounds(), count("toolkit.sync.payload_bytes")
    out = fn()
    return out, rounds() - r0, int(count("toolkit.sync.payload_bytes") - b0)


def run_scenarios(rank: int, world: int) -> dict:
    import torch

    from torcheval_tpu_torch.examples import distributed_example
    from torcheval_tpu_torch.metrics import (
        BinaryAccuracy,
        BinaryAUROC,
        MulticlassAccuracy,
        MulticlassF1Score,
        SlicedMetricCollection,
        Sum,
    )
    from torcheval_tpu_torch.metrics.toolkit import (
        get_synced_metric,
        get_synced_state_dict,
        sync_and_compute,
        sync_and_compute_collection,
    )
    from torcheval_tpu_torch.ops.hist import sharded_class_counts
    from torcheval_tpu_torch.parallel import ShardedEvaluator, data_parallel_mesh, shard_batch
    from torcheval_tpu_torch.utils.test_utils.dummy_metric import DummySumDictStateMetric

    cpu = torch.device("cpu")
    res: dict = {"rank": rank}

    # --- Sum under every recipient rank and "all": 3 * (rank + 1) a rank
    s = Sum(device=cpu).update(torch.full((3,), float(rank + 1)))
    for key, recipient in (("sum_r0", 0), ("sum_r1", 1), ("sum_rall", "all")):
        out = sync_and_compute(s, recipient_rank=recipient)
        res[key] = None if out is None else float(out)
    res["sum_source_after"] = float(s.compute())

    # --- accuracy and every F1 average against one stream
    scores, labels = make_acc_shard(rank)
    acc = MulticlassAccuracy(num_classes=NUM_CLASSES, device=cpu).update(scores, labels)
    macro = MulticlassAccuracy(average="macro", num_classes=NUM_CLASSES, device=cpu).update(scores, labels)
    f1s = {k: m.update(scores, labels) for k, m in _f1s(cpu).items()}
    res["acc_all"] = float(sync_and_compute(acc, recipient_rank="all"))
    res["macro_acc_all"] = float(sync_and_compute(macro, recipient_rank="all"))
    for k, m in f1s.items():
        synced = get_synced_metric(m, recipient_rank="all")
        res[f"f1_{k}"] = _list(synced.compute())
        res[f"f1_{k}_counts"] = [
            _list(getattr(synced, n)) for n in ("num_tp", "num_label", "num_prediction")
        ]

    # --- get_synced_metric / get_synced_state_dict on rank 1 only
    synced = get_synced_metric(acc, recipient_rank=1)
    res["synced_metric_r1"] = None if synced is None else float(synced.compute())
    sd = get_synced_state_dict(acc, recipient_rank=1)
    res["synced_sd_r1_keys"] = sorted(sd)
    res["synced_sd_r1_num_total"] = float(sd["num_total"]) if sd else None

    # --- BinaryAUROC with uneven CAT caches and an empty rank, raw and
    # compacting
    a_s, a_t = make_auroc_shard(rank)
    auroc = BinaryAUROC(device=cpu)
    compacting = BinaryAUROC(compaction_threshold=16, device=cpu)
    if a_s.size:
        auroc.update(a_s, a_t)
        compacting.update(a_s, a_t)
    res["auroc_all"] = float(sync_and_compute(auroc, recipient_rank="all"))
    out = sync_and_compute(auroc, recipient_rank=0)
    res["auroc_r0"] = None if out is None else float(out)
    res["auroc_compacting_all"] = float(sync_and_compute(compacting, recipient_rank="all"))

    # --- a dict-keyed (CUSTOM) state through the object lane
    d = DummySumDictStateMetric(device=cpu)
    for key, v in make_dict_updates(rank):
        d.update(key, torch.tensor([v]))
    res["dict_all"] = float(sync_and_compute(d, recipient_rank="all"))
    synced = get_synced_metric(d, recipient_rank=0)
    res["dict_keys_r0"] = None if synced is None else sorted(synced.x)

    # --- a WINDOW deque: 8 rows worldwide into a window of 6
    w = _window_metric(cpu)
    for row in make_window_rows(rank):
        w.update(row)
    out, rounds, nbytes = _rounds(lambda: sync_and_compute(w, recipient_rank="all"))
    res["window_rows"] = _list(out)
    res["window_rounds"] = rounds
    res["window_payload_bytes"] = nbytes

    # --- collections: values, recipients, exactly two rounds
    metrics = {"acc": acc, "auroc": auroc, "sum": s, "f1": f1s["macro"]}
    out, rounds, _ = _rounds(lambda: sync_and_compute_collection(metrics, recipient_rank="all"))
    res["collection_all"] = {k: float(v) for k, v in out.items()}
    res["rounds_collection"] = rounds
    out = sync_and_compute_collection(metrics, recipient_rank=1)
    res["collection_r1"] = None if out is None else sorted(out)
    _, res["rounds_acc"], _ = _rounds(lambda: sync_and_compute(acc, recipient_rank="all"))
    _, res["rounds_auroc"], _ = _rounds(lambda: sync_and_compute(auroc, recipient_rank="all"))
    out, res["rounds_window_plus_dict"], _ = _rounds(
        lambda: sync_and_compute_collection({"w": w, "d": d}, recipient_rank="all")
    )
    res["window_plus_dict_dict"] = float(out["d"])

    # --- a ragged sliced collection
    scol = SlicedMetricCollection({"acc": BinaryAccuracy(device=cpu), "sum": Sum(device=cpu)}, capacity=4)
    for ids, sc, tg in make_sliced_shard(rank):
        scol.update(ids, sc, tg)
    out, res["rounds_sliced"], _ = _rounds(
        lambda: sync_and_compute_collection(dict(scol.metrics), recipient_rank="all")
    )
    res["sliced_ids"] = [int(i) for i in out["acc"]["slice_ids"]]
    res["sliced_acc"] = _list(out["acc"]["values"])
    res["sliced_sum_ids"] = [int(i) for i in out["sum"]["slice_ids"]]
    res["sliced_sum"] = _list(out["sum"]["values"])

    # --- a processes= subgroup: members 1 and 3
    if rank in SUBGROUP:
        sub = Sum(device=cpu).update(torch.full((10,), float(rank + 1)))
        res["subgroup_sum_all"] = float(sync_and_compute(sub, recipient_rank="all", processes=SUBGROUP))
        out = sync_and_compute(sub, recipient_rank=3, processes=SUBGROUP)
        res["subgroup_sum_r3"] = None if out is None else float(out)
        try:
            sync_and_compute(sub, recipient_rank=0, processes=SUBGROUP)
            res["subgroup_bad_recipient"] = False
        except ValueError:
            res["subgroup_bad_recipient"] = True
        col = sync_and_compute_collection(
            {"s": sub, "auroc": auroc, "d": d}, recipient_rank="all", processes=SUBGROUP
        )
        res["subgroup_collection"] = {k: float(v) for k, v in col.items()}
        sd = get_synced_state_dict(sub, recipient_rank=1, processes=SUBGROUP)
        res["subgroup_sd_r1"] = float(sd["weighted_sum"]) if sd else None
        # a mesh over the subgroup: its two ranks split every global batch
        sub_mesh = data_parallel_mesh(SUBGROUP, device="cpu")
        sub_ev = ShardedEvaluator(MulticlassAccuracy(num_classes=NUM_CLASSES, device=cpu), mesh=sub_mesh)
        for sc, lb in make_eval_batches():
            sub_ev.update(*shard_batch(sub_mesh, sc, lb))
        res["subgroup_evaluator"] = float(sub_ev.compute())
        res["subgroup_mesh"] = [sub_mesh.size, sub_mesh.rank]
    else:
        try:
            sync_and_compute(Sum(device=cpu), processes=SUBGROUP)
            res["subgroup_nonmember_error"] = False
        except ValueError:
            res["subgroup_nonmember_error"] = True

    # --- the sharded class counts
    counts = sharded_class_counts(torch.from_numpy(make_hist_labels(rank)), HIST_CLASSES)
    res["sharded_counts"] = counts.tolist()
    res["sharded_counts_dtype"] = str(counts.dtype)

    # --- ShardedEvaluator over the mesh, fed each rank's block of every
    # global batch (the last one uneven)
    mesh = data_parallel_mesh(device="cpu")
    ev = ShardedEvaluator(
        {
            "acc": MulticlassAccuracy(num_classes=NUM_CLASSES, device=cpu),
            "f1": MulticlassF1Score(num_classes=NUM_CLASSES, average="macro", device=cpu),
        },
        mesh=mesh,
    )
    ev_auroc = ShardedEvaluator(BinaryAUROC(device=cpu), mesh=mesh)
    rows = 0
    for sc, lb in make_eval_batches():
        local_s, local_l = shard_batch(mesh, sc, lb)
        rows += local_s.shape[0]
        ev.update(local_s, local_l)
        ev_auroc.update(local_s[:, 0], (local_l == 0).float())
    out = ev.compute()
    res["evaluator"] = {k: float(v) for k, v in out.items()}
    res["evaluator_auroc"] = float(ev_auroc.compute())
    res["evaluator_rows"] = rows
    res["evaluator_mesh"] = [mesh.size, mesh.rank]

    # --- the distributed example at this world size
    res["example"] = distributed_example.run(device="cpu")

    # --- joining again is a no-op that reports the world
    from torcheval_tpu_torch.parallel import init_from_env

    res["init_again"] = list(init_from_env(device="cpu"))
    return res


def main(run=run_scenarios) -> None:
    """Join the world named by the command line, run ``run(rank, world)``
    and write its results (``sketch_sync_worker`` passes its own)."""
    rank, world, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    # join through the public bootstrap, fed torchrun-style variables
    os.environ.update(
        MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(world), RANK=str(rank)
    )
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.parallel import init_from_env, shutdown

    obs.enable()  # the rounds and their bytes are its counters
    got = init_from_env(device="cpu")
    assert got == (rank, world), got
    res = run(rank, world)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    shutdown()


if __name__ == "__main__":
    main()
