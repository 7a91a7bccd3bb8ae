"""One rank of the distributed-curve test worlds, on gloo and the CPU.

JAX counterpart: none. The JAX package tests ``ops/dist_curves.py`` and the
curve metrics' sharded paths in one process on a forced 8-device CPU mesh
(``tests/ops/test_dist_curves.py``). The port runs one process per rank,
so its test module launches four of these workers:

    python -m torcheval_tpu_torch.utils.test_utils.dist_curves_worker <scenario> <rank> <world> <port> <outdir>

``scenario`` is ``kernels`` (the ``sharded_*`` functions on each rank's
block of every case, even and ragged splits, raw and with each
``quantize`` mode) or ``evaluator`` (the curve
metrics through ``ShardedEvaluator``: the route counter, the fallbacks, a
2 x 2 mesh's data groups, a JAX-written state). Each process writes
``<outdir>/rank<r>.json``; the ``evaluator`` scenario reads
``<outdir>/jax_state_rank<r>.npz`` (a JAX ``BinaryAUROC``'s state on that
rank's block, written by the test). The data helpers are numpy only and
deterministic, so the test rebuilds every global input for its references.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from torcheval_tpu_torch import obs
from torcheval_tpu_torch.utils.test_utils.obs_counts import count, parse_key, rounds

WORLD = 4
QUANTIZE_MODES = ("bf16", "int8")
SKETCH_BITS = 10
MC_SKETCH_BITS = 10


# ------------------------------------------------------------------- data
def tied(n: int, seed: int):
    """``tests/ops/test_dist_curves.py``'s tied scores: 300 levels."""
    rng = np.random.default_rng(seed)
    s = ((rng.random(n) * 300).astype(np.int32) / 300.0).astype(np.float32)
    t = (rng.random(n) < 0.4).astype(np.float32)
    return s, t


def mc_tied(n: int, c: int, seed: int):
    rng = np.random.default_rng(seed)
    s = ((rng.random((n, c)) * 300).astype(np.int32) / 300.0).astype(np.float32)
    t = rng.integers(0, c, size=n).astype(np.int64)
    return s, t


def kernel_cases():
    """``(name, which, batches)``: every batch's rows divide by the world,
    so each rank's block of each batch is the JAX mesh device's block."""
    w = WORLD
    rng = np.random.default_rng(31)
    cases = [
        ("auroc_ties_multi_batch", "auroc", [tied(w * (200 + 100 * i), 40 + i) for i in range(3)]),
        ("auprc_ties", "auprc", [tied(w * 250, 50 + i) for i in range(2)]),
        ("auroc_uniform", "auroc", [(rng.random(w * 700).astype(np.float32),
                                     (rng.random(w * 700) < 0.3).astype(np.float32))]),
        ("auprc_uniform", "auprc", [(rng.standard_normal(w * 500).astype(np.float32) * 5,
                                     (rng.random(w * 500) < 0.5).astype(np.float32))]),
    ]
    s = np.array([0.9, -np.inf, 0.4, -np.inf, 0.1, 0.7, 0.2, 0.3] * 32, np.float32)
    t = (np.random.default_rng(60).random(s.size) < 0.5).astype(np.float32)
    cases += [("auroc_neg_inf", "auroc", [(s, t)]), ("auprc_neg_inf", "auprc", [(s, t)])]
    s, t = tied(3200, 61)
    s[:100], t[:100] = 0.0, 1.0
    s[100:200], t[100:200] = -0.0, 0.0
    perm = np.random.default_rng(0).permutation(3200)  # spread across ranks
    cases += [("auroc_signed_zeros", "auroc", [(s[perm], t[perm])]),
              ("auprc_signed_zeros", "auprc", [(s[perm], t[perm])])]
    s, _ = tied(800, 62)
    for fill, label in ((1.0, "positive"), (0.0, "negative")):
        t = np.full(800, fill, np.float32)
        cases += [(f"auroc_all_{label}", "auroc", [(s, t)]), (f"auprc_all_{label}", "auprc", [(s, t)])]
    # at 4 ranks and F = 4 a bucket's capacity is a whole even block: the
    # heaviest skew still fits (capacity_cases lowers F to trip it)
    n = w * 128
    t = (np.random.default_rng(63).random(n) < 0.5).astype(np.float32)
    cases += [("auroc_all_equal", "auroc", [(np.full(n, 0.5, np.float32), t)]),
              ("auprc_all_equal", "auprc", [(np.full(n, 0.5, np.float32), t)])]
    skew = np.where(np.random.default_rng(64).random(w * 2000) < 0.8, 0.5, 0.25).astype(np.float32)
    t = (np.random.default_rng(65).random(w * 2000) < 0.4).astype(np.float32)
    cases.append(("auroc_massive_ties", "auroc", [(skew, t)]))
    s, t = tied(w * 200, 66)
    s[3] = np.nan
    s[w * 100] = np.nan
    cases += [("auroc_nan", "auroc", [(s, t)]), ("auprc_nan", "auprc", [(s, t)])]
    cases += [("mc_auroc_ties", "mc_auroc", [mc_tied(w * 250, 6, 70)]),
              ("mc_auprc_ties", "mc_auprc", [mc_tied(w * 200, 4, 71)]),
              ("mc_auroc_two_batches", "mc_auroc", [mc_tied(w * 100, 5, 72), mc_tied(w * 60, 5, 73)])]
    s, t = mc_tied(w * 150, 3, 74)
    s[5, 1] = np.nan
    s[77, 0] = np.nan
    cases += [("mc_auroc_nan", "mc_auroc", [(s, t)]), ("mc_auprc_nan", "mc_auprc", [(s, t)])]
    s, t = mc_tied(w * 128, 3, 75)
    s[:, 1] = 0.5
    cases.append(("mc_auroc_one_tied_class", "mc_auroc", [(s, t)]))
    return cases


# the capacity factor of capacity_cases: at F = 1 a bucket sends at most a
# quarter of an even block, so ties overflow (shapes of their own, since a
# JAX program keeps the capacity of its first trace at a shape)
LOW_CAPACITY_FACTOR = 1


def capacity_cases():
    """``(name, which, batches)`` run at ``LOW_CAPACITY_FACTOR``."""
    w = WORLD
    n = w * 132
    t = (np.random.default_rng(130).random(n) < 0.5).astype(np.float32)
    skew = np.where(np.random.default_rng(131).random(w * 1004) < 0.8, 0.5, 0.25).astype(np.float32)
    ts = (np.random.default_rng(132).random(w * 1004) < 0.4).astype(np.float32)
    x, y = mc_tied(w * 136, 3, 133)
    x[:, 1] = 0.5
    return [("auroc_all_equal", "auroc", [(np.full(n, 0.5, np.float32), t)]),
            ("auprc_all_equal", "auprc", [(np.full(n, 0.5, np.float32), t)]),
            ("auroc_massive_ties", "auroc", [(skew, ts)]),
            ("auroc_ties", "auroc", [tied(w * 252, 134)]),
            ("mc_auroc_one_tied_class", "mc_auroc", [(x, y)]),
            ("mc_auprc_one_tied_class", "mc_auprc", [(x, y)])]


# ragged row counts of the four ranks: one rank with no rows
RAGGED_SPLIT = (37, 0, 400, 163)


def ragged_cases():
    """``(name, which, (s, t))`` of ``sum(RAGGED_SPLIT)`` global rows."""
    n = sum(RAGGED_SPLIT)
    rng = np.random.default_rng(80)
    s, t = tied(n, 81)
    u = rng.random(n).astype(np.float32)
    mc = mc_tied(n, 4, 82)
    return [("auroc_ties", "auroc", (s, t)), ("auprc_ties", "auprc", (s, t)),
            ("auroc_uniform", "auroc", (u, t)), ("mc_auroc", "mc_auroc", mc),
            ("mc_auprc", "mc_auprc", mc)]


def ragged_overflow():
    """Every score equal over the ragged split: each rank's rows land in one
    bucket of capacity ``ceil(4 * 150 / 4) = 150``, so ranks 2 and 3 lose
    250 and 13 rows."""
    n = sum(RAGGED_SPLIT)
    return np.full(n, 0.5, np.float32), (np.random.default_rng(83).random(n) < 0.5).astype(np.float32)


def ragged_block(x: np.ndarray, rank: int) -> np.ndarray:
    start = sum(RAGGED_SPLIT[:rank])
    return x[start : start + RAGGED_SPLIT[rank]]


def even_block(x: np.ndarray, rank: int, world: int = WORLD) -> np.ndarray:
    n = x.shape[0] // world
    return x[rank * n : (rank + 1) * n]


def sketch_data():
    """Binary and multiclass staged rows for the sketch counts, NaN
    included."""
    rng = np.random.default_rng(90)
    n = WORLD * 300
    s = (rng.standard_normal(n) * 3).astype(np.float32)
    s[::97] = np.nan
    t = (rng.random(n) < 0.4).astype(np.float32)
    x, y = mc_tied(n, 5, 91)
    x[4, 2] = np.nan
    return (s, t), (x, y)


def evaluator_batches(kind: str):
    """Global batches for the evaluator cases (rows divide by the world)."""
    w = WORLD
    if kind == "binary":
        return [tied(w * 200, 100 + i) for i in range(3)]
    if kind == "multiclass":
        return [mc_tied(w * 150, 5, 110 + i) for i in range(2)]
    if kind == "overflow":  # fed over OVERFLOW_SPLIT
        n = sum(OVERFLOW_SPLIT)
        s = np.where(np.random.default_rng(120).random(n) < 0.8, 0.75, 0.25).astype(np.float32)
        return [(s, (np.random.default_rng(128).random(n) < 0.5).astype(np.float32))]
    if kind == "nan":
        s, t = tied(w * 150, 121)
        s[7] = np.nan
        return [(s, t)]
    if kind == "skew":
        n = w * 2000
        s = np.where(np.random.default_rng(122).random(n) < 0.8, 0.5, 0.25).astype(np.float32)
        return [(s, (np.random.default_rng(123).random(n) < 0.4).astype(np.float32))]
    if kind == "state":
        return [tied(w * 250, 124)]
    raise ValueError(kind)


# rows of the overflow case: about 800 tied rows on rank 0 against a
# bucket capacity of ceil(4 * 268 / 4) = 268
OVERFLOW_SPLIT = (1000, 24, 24, 24)

# rows of the summary case: rank 0 crosses the compaction threshold alone
SUMMARY_SPLIT = (400, 100, 100, 100)
SUMMARY_THRESHOLD = 300


def _list(t) -> list:
    return np.asarray(t.detach().cpu(), np.float64).reshape(-1).tolist()


def _collectives():
    from torcheval_tpu_torch.utils import dist as _dist

    return (_dist.all_reduce_sum.calls, _dist.all_gather_stacked.calls, _dist.all_to_all_rows.calls)


# -------------------------------------------------------------- scenarios
def run_kernels(rank: int, world: int, outdir: str) -> dict:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from torcheval_tpu_torch.ops import dist_curves as dc
    from torcheval_tpu_torch.utils.dist import mesh_axis

    fns = {"auroc": dc.sharded_binary_auroc, "auprc": dc.sharded_binary_auprc,
           "mc_auroc": dc.sharded_multiclass_auroc, "mc_auprc": dc.sharded_multiclass_auprc}
    res = {"even": {}, "ragged": {}}
    for name, which, batches in kernel_cases():
        s_list = [torch.from_numpy(even_block(s, rank)) for s, _ in batches]
        t_list = [torch.from_numpy(even_block(t, rank)) for _, t in batches]
        before = _collectives()
        sent_before = _send_bytes()
        value, err = fns[which](s_list, t_list)
        res["even"][name] = {
            "value": _list(value), "error_rows": err,
            "collectives": [a - b for a, b in zip(_collectives(), before)],
            "send_bytes": _send_bytes() - sent_before,
        }
        for mode in QUANTIZE_MODES:
            before = _collectives()
            sent_before = _send_bytes()
            q_value, q_err = fns[which](s_list, t_list, quantize=mode)
            res["even"][name][str(mode)] = {
                "value": _list(q_value), "error_rows": q_err,
                "bit_equal": bool(torch.equal(q_value, value)),
                "collectives": [a - b for a, b in zip(_collectives(), before)],
                "send_bytes": _send_bytes() - sent_before,
            }
    for name, which, (s, t) in ragged_cases() + [("auroc_overflow", "auroc", ragged_overflow())]:
        for mode in (None,) + QUANTIZE_MODES:
            value, err = fns[which]([torch.from_numpy(ragged_block(s, rank))],
                                    [torch.from_numpy(ragged_block(t, rank))], quantize=mode or False)
            res["ragged"][name if mode is None else f"{name}/{mode}"] = {
                "value": _list(value), "error_rows": err}
    # the route's veto: rank 1 abstains, every rank stops after one collective
    res["abstain"] = {}
    for mode in (False,) + QUANTIZE_MODES:
        s, t = tied(WORLD * 50, 99)
        before = _collectives()
        out = dc.curve_value("auroc", [torch.from_numpy(even_block(s, rank))],
                             [torch.from_numpy(even_block(t, rank))], abstain=rank == 1,
                             quantize=mode)
        res["abstain"][str(mode)] = {"none": out is None,
                                     "collectives": [a - b for a, b in zip(_collectives(), before)]}
    # the environment variable picks the mode when quantize is None
    _, which, batches = kernel_cases()[0]
    os.environ["TORCHEVAL_TPU_SYNC_QUANTIZE"] = "int8"
    sent_before = _send_bytes()
    before = _collectives()
    fns[which]([torch.from_numpy(even_block(s, rank)) for s, _ in batches],
               [torch.from_numpy(even_block(t, rank)) for _, t in batches])
    res["env_int8"] = {"collectives": [a - b for a, b in zip(_collectives(), before)],
                       "send_bytes": _send_bytes() - sent_before}
    del os.environ["TORCHEVAL_TPU_SYNC_QUANTIZE"]
    res["low_capacity"] = {}
    dc.DIST_CAPACITY_FACTOR = LOW_CAPACITY_FACTOR
    try:
        for name, which, batches in capacity_cases():
            value, err = fns[which]([torch.from_numpy(even_block(s, rank)) for s, _ in batches],
                                    [torch.from_numpy(even_block(t, rank)) for _, t in batches])
            res["low_capacity"][name] = {"value": _list(value), "error_rows": err}
            for mode in QUANTIZE_MODES:
                _, q_err = fns[which]([torch.from_numpy(even_block(s, rank)) for s, _ in batches],
                                      [torch.from_numpy(even_block(t, rank)) for _, t in batches],
                                      quantize=mode)
                res["low_capacity"][name][mode] = q_err
    finally:
        dc.DIST_CAPACITY_FACTOR = 4
    # a DeviceMesh dim as the group
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    _, which, batches = kernel_cases()[0]
    value, err = fns[which]([torch.from_numpy(even_block(s, rank)) for s, _ in batches],
                            [torch.from_numpy(even_block(t, rank)) for _, t in batches],
                            group=mesh_axis(mesh, "data"))
    res["mesh_axis_group"] = {"value": _list(value), "error_rows": err}
    # the sketch counts: even blocks (against JAX) and ragged ones
    (s, t), (x, y) = sketch_data()
    res["sketch"] = {}
    for split, block in (("even", even_block), ("ragged", ragged_block)):
        if split == "ragged":
            s, t = np.resize(s, sum(RAGGED_SPLIT)), np.resize(t, sum(RAGGED_SPLIT))
            x, y = np.resize(x, (sum(RAGGED_SPLIT), x.shape[1])), np.resize(y, sum(RAGGED_SPLIT))
        before = _collectives()
        tp, fp, nan = dc.sharded_sketch_counts([torch.from_numpy(block(s, rank))],
                                               [torch.from_numpy(block(t, rank))],
                                               bucket_bits=SKETCH_BITS)
        mtp, mfp, mnan = dc.sharded_sketch_counts([torch.from_numpy(block(x, rank))],
                                                  [torch.from_numpy(block(y, rank))],
                                                  bucket_bits=MC_SKETCH_BITS, num_classes=x.shape[1])
        res["sketch"][split] = {
            "binary": [tp.tolist(), fp.tolist(), int(nan)],
            "multiclass": [mtp.tolist(), mfp.tolist(), int(mnan)],
            "collectives": [a - b for a, b in zip(_collectives(), before)],
        }
    return res


def _feed(ev, batches, rank: int, world: int, split=None):
    import torch

    from torcheval_tpu_torch.parallel import block_bounds

    for s, t in batches:
        if split is None:
            lo, hi = block_bounds(s.shape[0], world, rank)
        else:
            lo = sum(split[:rank])
            hi = lo + split[rank]
        ev.update(torch.from_numpy(s[lo:hi]), torch.from_numpy(t[lo:hi]))
    return ev


def _snapshot(metric) -> dict:
    return {name: [p.clone() for p in (v if isinstance(v, list) else [v])]
            for name, v in metric.state_dict().items()}


def _same(a: dict, b: dict) -> bool:
    import torch

    return a.keys() == b.keys() and all(
        len(a[k]) == len(b[k]) and all(torch.equal(x, y) for x, y in zip(a[k], b[k])) for k in a)


def _compute(ev) -> dict:
    """The evaluator's results, with the route counter and the toolkit's
    gather rounds that the compute ran."""
    calls, before = _routes(), rounds()
    out = ev.compute()
    out = out if isinstance(out, dict) else {"metric": out}
    routes = {k: n - calls.get(k, 0) for k, n in _routes().items() if n != calls.get(k, 0)}
    return {"values": {k: _list(v) for k, v in out.items()}, "routes": routes,
            "gather_rounds": rounds() - before}


def _routes() -> dict:
    """``{"path/family": n}`` of the curve metrics' route counter."""
    out = {}
    for key, n in obs.snapshot()["counters"].items():
        name, labels = parse_key(key)
        if name == "ops.dist_curves.calls":
            out[f"{labels['path']}/{labels['family']}"] = int(n)
    return out


def _send_bytes() -> int:
    """The bytes that entered the distributed curves' exchanges."""
    return int(count("dist_curves.exchange_send_bytes"))


def run_evaluator(rank: int, world: int, outdir: str) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from torcheval_tpu_torch.metrics import (
        BinaryAUPRC,
        BinaryAUROC,
        MulticlassAccuracy,
        MulticlassAUPRC,
        MulticlassAUROC,
    )
    from torcheval_tpu_torch.parallel import ShardedEvaluator, block_bounds, data_parallel_mesh
    from torcheval_tpu_torch.utils.dist import mesh_axis
    from torcheval_tpu_torch.utils.jax_state import load_jax_state_dict

    cpu = dict(device="cpu")
    mesh = data_parallel_mesh(**cpu)
    res = {}

    def binary():
        return {"auroc": BinaryAUROC(**cpu), "auprc": BinaryAUPRC(**cpu)}

    ev = _feed(ShardedEvaluator(binary(), mesh=mesh), evaluator_batches("binary"), rank, world)
    before = {k: _snapshot(m) for k, m in ev.metrics.items()}
    res["binary"] = _compute(ev)
    res["state_unchanged"] = all(_same(before[k], _snapshot(m)) for k, m in ev.metrics.items())
    res["binary_again"] = _compute(ev)

    mc = {"auroc": MulticlassAUROC(num_classes=5, average=None, **cpu),
          "auprc": MulticlassAUPRC(num_classes=5, average=None, **cpu),
          "macro": MulticlassAUROC(num_classes=5, **cpu)}
    res["multiclass"] = _compute(_feed(ShardedEvaluator(mc, mesh=mesh), evaluator_batches("multiclass"),
                                       rank, world))
    for kind, split in (("overflow", OVERFLOW_SPLIT), ("nan", None), ("skew", None)):
        res[kind] = _compute(_feed(ShardedEvaluator(binary(), mesh=mesh), evaluator_batches(kind),
                                   rank, world, split))
    # rank 0 alone crosses the compaction threshold: its summary vetoes
    ev = ShardedEvaluator({"auroc": BinaryAUROC(compaction_threshold=SUMMARY_THRESHOLD, **cpu)},
                          mesh=mesh)
    s, t = tied(sum(SUMMARY_SPLIT), 125)
    res["summary_on_one_rank"] = _compute(_feed(ev, [(s, t)], rank, world, SUMMARY_SPLIT))
    # a rank with no rows, and no rows at all
    res["empty_rank"] = _compute(_feed(ShardedEvaluator(binary(), mesh=mesh), [tied(37, 126)],
                                       rank, world, (20, 0, 10, 7)))
    res["no_rows"] = _compute(ShardedEvaluator({**binary(), "mc": MulticlassAUROC(num_classes=3, **cpu)},
                                               mesh=mesh))
    # beside a member that syncs: one collection sync for the rest
    ev = ShardedEvaluator({"acc": MulticlassAccuracy(num_classes=5, **cpu),
                           "auroc": MulticlassAUROC(num_classes=5, **cpu)}, mesh=mesh)
    res["mixed"] = _compute(_feed(ev, evaluator_batches("multiclass"), rank, world))
    # a merged cache: rank 0 merges an unsharded replica's rows first
    ev = _feed(ShardedEvaluator(BinaryAUROC(**cpu), mesh=mesh), evaluator_batches("binary")[:1],
               rank, world)
    if rank == 0:
        other = BinaryAUROC(**cpu)
        s, t = tied(999, 127)
        other.update(torch.from_numpy(s), torch.from_numpy(t))
        ev.metrics["metric"].merge_state([other])
    res["merged"] = _compute(ev)
    # approximate members: the sketch all-reduce, a resident sketch and
    # staged rows on every rank
    approx = {"auroc": BinaryAUROC(approx=True, compaction_threshold=300, **cpu),
              "auprc": BinaryAUPRC(approx=1024, **cpu)}
    res["approx_binary"] = _compute(_feed(ShardedEvaluator(approx, mesh=mesh),
                                          evaluator_batches("binary"), rank, world))
    approx = {"auroc": MulticlassAUROC(num_classes=5, average=None, approx=True, **cpu),
              "auprc": MulticlassAUPRC(num_classes=5, approx=True, compaction_threshold=200, **cpu)}
    res["approx_multiclass"] = _compute(_feed(ShardedEvaluator(approx, mesh=mesh),
                                              evaluator_batches("multiclass"), rank, world))
    # a JAX-written raw-cache state on each rank
    ev = ShardedEvaluator(BinaryAUROC(**cpu), mesh=mesh)
    with np.load(os.path.join(outdir, f"jax_state_rank{rank}.npz")) as f:
        # a cache state's one array, or an empty cache
        state = {k: ([f[k]] if k in f.files else []) if isinstance(v, list) else f[k]
                 for k, v in ev.metrics["metric"].state_dict().items()}
    load_jax_state_dict(ev.metrics["metric"], state)
    res["jax_state"] = _compute(ev)
    # a 2 x 2 ("data", "model") mesh: rows split over each data group, the
    # model replicas fed alike; each data group runs its own exchange
    mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    data = mesh_axis(mesh2, "data")
    data_ranks = dist.get_process_group_ranks(data.group)
    dp = data_parallel_mesh(data_ranks, **cpu)
    ev = ShardedEvaluator({"auroc": BinaryAUROC(**cpu),
                           "mc": MulticlassAUROC(num_classes=5, average=None, **cpu)}, mesh=dp)
    for (s, t), (x, y) in zip(evaluator_batches("binary")[:2], evaluator_batches("multiclass")):
        lo, hi = block_bounds(s.shape[0], data.size, data.rank)
        ev.metrics["auroc"].update(torch.from_numpy(s[lo:hi]), torch.from_numpy(t[lo:hi]))
        lo, hi = block_bounds(x.shape[0], data.size, data.rank)
        ev.metrics["mc"].update(torch.from_numpy(x[lo:hi]), torch.from_numpy(y[lo:hi]))
    res["multi_axis"] = {"data_ranks": data_ranks, **_compute(ev)}
    return res


SCENARIOS = {"kernels": run_kernels, "evaluator": run_evaluator}


def launch_world(scenario: str, outdir: str, timeout_s: float) -> list:
    """The four ranks of ``scenario`` (``sharded_worker.launch_world``)."""
    from torcheval_tpu_torch.utils.test_utils.sharded_worker import launch_world as launch

    return launch(scenario, outdir, timeout_s, WORLD, module=__name__)


def main() -> None:
    scenario, rank, world, port, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    os.environ.update(
        MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(world), RANK=str(rank)
    )
    os.environ.pop("TORCHEVAL_TPU_SYNC_QUANTIZE", None)
    from torcheval_tpu_torch.parallel import init_from_env
    from torcheval_tpu_torch.utils.test_utils.sharded_worker import leave_world

    obs.enable()  # the routes, rounds and exchange bytes are its counters
    got = init_from_env(device="cpu")
    assert got == (rank, world), got
    res = SCENARIOS[scenario](rank, world, outdir)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    leave_world()


if __name__ == "__main__":
    main()
