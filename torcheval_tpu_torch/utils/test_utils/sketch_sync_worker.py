"""One rank of the sketch sync test world, on gloo and the CPU.

JAX counterpart: the simulated-wire worlds of
``tests/sketch/test_sketch_sync.py``, here a real ``torch.distributed``
world of processes. Each rank streams its shard into ``approx=`` metrics
and ``Quantile``, syncs them through ``metrics/toolkit.py`` (one metric at a
time, a collection, and a sliced collection with a sketch member) and
writes the results to ``<outdir>/rank<r>.json``. Run one process per rank:

    python -m torcheval_tpu_torch.utils.test_utils.sketch_sync_worker <rank> <world> <port> <outdir>

The data helpers are deterministic in the rank and use numpy only, so a
test can rebuild the single-stream input for its references.
"""

from __future__ import annotations

import numpy as np

from torcheval_tpu_torch.utils.test_utils.sync_worker import main

# uneven binary shards, one rank's smaller than the fold cadence
BINARY_SIZES = [3000, 1100]
NUM_CLASSES = 4
MC_SIZES = [900, 1300]
RANK_BATCH = 300
SLICED_N = 400
SLICED_POOL = 9


def make_binary_shard(rank: int):
    rng = np.random.default_rng(300 + rank)
    n = BINARY_SIZES[rank]
    scores = rng.lognormal(0, 2, n).astype(np.float32) * np.where(rng.random(n) < 0.3, -1, 1)
    targets = (rng.random(n) < 0.4).astype(np.float32)
    return scores.astype(np.float32), targets


def make_mc_shard(rank: int):
    rng = np.random.default_rng(400 + rank)
    n = MC_SIZES[rank]
    return rng.random((n, NUM_CLASSES)).astype(np.float32), rng.integers(0, NUM_CLASSES, n)


def make_rank_shard(rank: int):
    rng = np.random.default_rng(500 + rank)
    return rng.random((RANK_BATCH, 12)).astype(np.float32), rng.integers(0, 12, RANK_BATCH)


def make_sliced_shard(rank: int):
    rng = np.random.default_rng(600 + rank)
    ids = rng.integers(0, SLICED_POOL, SLICED_N).astype(np.int64) * 17 + 3 * rank
    return ids, rng.random(SLICED_N).astype(np.float32), (rng.random(SLICED_N) < 0.4).astype(np.float32)


def _list(x):
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x).tolist()


def run_sketch_scenarios(rank: int, world: int) -> dict:
    import torch

    from torcheval_tpu_torch.metrics import (
        BinaryAccuracy,
        BinaryAUPRC,
        BinaryAUROC,
        Cat,
        HitRate,
        MulticlassAUPRC,
        Quantile,
        SlicedMetricCollection,
    )
    from torcheval_tpu_torch.utils.test_utils.obs_counts import rounds
    from torcheval_tpu_torch.metrics.toolkit import (
        get_synced_state_dict,
        sync_and_compute,
        sync_and_compute_collection,
    )

    cpu = torch.device("cpu")
    res: dict = {"rank": rank}
    s, t = make_binary_shard(rank)

    def binary(cls):
        m = cls(approx=True, compaction_threshold=2048, device=cpu)
        for a, b in zip(np.array_split(s, 3), np.array_split(t, 3)):
            m.update(a, b)
        return m

    auroc = binary(BinaryAUROC)
    res["auroc"] = float(sync_and_compute(auroc, recipient_rank="all"))
    sd = get_synced_state_dict(auroc, recipient_rank="all")
    res["auroc_sketch_tp"] = _list(sd["sketch_tp"])
    res["auroc_sketch_fp"] = _list(sd["sketch_fp"])
    res["auroc_staged_after_sync"] = len(sd["inputs"])
    res["auprc"] = float(sync_and_compute(binary(BinaryAUPRC), recipient_rank="all"))

    x, lbl = make_mc_shard(rank)
    mc = MulticlassAUPRC(num_classes=NUM_CLASSES, average=None, approx=True, device=cpu)
    mc.update(x, lbl)
    res["mc_auprc"] = _list(sync_and_compute(mc, recipient_rank="all"))

    q = Quantile((0.1, 0.5, 0.9), device=cpu)
    q.update(s)
    res["quantile"] = _list(sync_and_compute(q, recipient_rank="all"))
    res["quantile_counts"] = _list(get_synced_state_dict(q, recipient_rank="all")["bucket_counts"])

    cat = Cat(approx=1024, device=cpu)
    cat.update(s)
    vals, counts = sync_and_compute(cat, recipient_rank="all")
    res["cat_values"], res["cat_counts"] = _list(vals), _list(counts)

    rx, rt = make_rank_shard(rank)
    res["hit_rate"] = float(sync_and_compute(HitRate(k=3, approx=True, device=cpu).update(rx, rt),
                                             recipient_rank="all"))

    # a collection of sketches: two rounds, as any collection
    r0 = rounds()
    out = sync_and_compute_collection(
        {"auroc": binary(BinaryAUROC), "q": Quantile(0.5, device=cpu).update(s)},
        recipient_rank="all",
    )
    res["collection_rounds"] = rounds() - r0
    res["collection_auroc"] = float(out["auroc"])
    res["collection_q"] = float(out["q"])

    # a NaN on rank 1 only: every rank raises after the sync
    nan_metric = BinaryAUROC(approx=True, device=cpu)
    bad = s.copy()
    if rank == 1:
        bad[0] = np.nan
    nan_metric.update(bad, t)
    try:
        sync_and_compute(nan_metric, recipient_rank="all")
        res["nan_raised"] = False
    except ValueError as err:
        res["nan_raised"] = "NaN" in str(err)

    # a ragged sliced collection with a sketch member
    ids, ss, st = make_sliced_shard(rank)
    scol = SlicedMetricCollection(
        {"acc": BinaryAccuracy(device=cpu), "auroc": BinaryAUROC(approx=1024, device=cpu)},
        capacity=4,
        curve_bucket_bits=6,
    )
    scol.update(ids, ss, st)
    sout = sync_and_compute_collection(dict(scol.metrics), recipient_rank="all")
    res["sliced_ids"] = [int(i) for i in sout["auroc"]["slice_ids"]]
    res["sliced_auroc"] = _list(sout["auroc"]["values"])
    return res


if __name__ == "__main__":
    main(run_sketch_scenarios)
