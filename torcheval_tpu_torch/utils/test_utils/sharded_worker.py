"""One rank of the sharded-kernel test worlds, on gloo and the CPU.

JAX counterpart: none. The JAX package tests its sharded forms
(``sharded_pallas_topk``, ``sharded_label_topk``, ``segment_scatter``'s
mesh route, ``sharded_pallas_segment_sum``, the slice-sharded
``SlicedMetricCollection``) in one process on a forced 8-device CPU mesh.
The port runs one process per rank, so each test module launches four of
these workers, one world per module:

    python -m torcheval_tpu_torch.utils.test_utils.sharded_worker <scenario> <rank> <world> <port> <outdir>

``scenario`` is ``topk``, ``scatter`` or ``sliced``. Each process joins
through ``parallel.init_from_env``, builds its ``DeviceMesh``es with
``init_device_mesh("cpu", ...)``, runs the scenario on its tiles and
writes ``<outdir>/rank<r>.json``; the ``sliced`` scenario also reads
``<outdir>/jax_state.npz`` (a JAX collection's state, written by the test)
and rank 0 writes ``<outdir>/port_state*.npz``. The data helpers are numpy
only and deterministic, so that the tests rebuild every input for their
JAX references.
"""

from __future__ import annotations

import copy
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

WORLD = 4
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

# --------------------------------------------------------------- top-k data
RETRIEVAL_N, RETRIEVAL_L, RETRIEVAL_K, RETRIEVAL_BATCH = 64, 301, 10, 16
ROW_SHARDED_SHAPE = (32, 2048)
ROW_SHARDED_UNEVEN = (30, 2048)
PAIR_SHAPE = (16, 1536)


def signed_zero_rows() -> np.ndarray:
    """Rows of -0.0, +0.0, -inf and +-1 in every order, 12 labels wide."""
    rng = np.random.default_rng(5)
    pool = np.asarray([-0.0, 0.0, -np.inf, -1.0, 1.0], np.float32)
    x = pool[rng.integers(0, pool.shape[0], (9, 12))]
    # no positive score: +0.0 (1, 3, 8) ranks before -0.0 (0, 5, 9)
    x[0] = [-0.0, 0.0, -1.0, 0.0, -np.inf, -0.0, -1.0, -np.inf, 0.0, -0.0, -1.0, -np.inf]
    x[1] = -np.inf
    x[1, 5] = -0.0
    return x


def label_cases():
    """``(name, scores, k, method)``: the JAX package's label-sharded cases
    (``tests/ops/test_topk_sharded_label.py``) and the port's own."""
    rng = np.random.default_rng(14)
    cases = []
    for shape, k in (((13, 4096), 5), ((4, 1024), 7), ((64, 2048), 1)):
        cases.append((f"random_{shape[0]}x{shape[1]}_k{k}", rng.random(shape, dtype=np.float32), k, "auto"))
    cases.append(("ties", rng.integers(0, 4, (32, 2048)).astype(np.float32), 9, "auto"))
    cases.append(("ties_kernel", rng.integers(0, 5, (16, 2048)).astype(np.float32), 7, "kernel"))
    cases.append(("all_equal", np.ones((8, 1024), np.float32), 5, "auto"))
    x = np.full((6, 1001), -np.inf, np.float32)
    x[:, 700] = 1.0
    cases.append(("neg_inf_beats_padding", x, 4, "auto"))
    x = rng.random((5, 2048)).astype(np.float32)
    x[:, [3, 900, 1999]] = np.inf
    cases.append(("pos_inf_ties", x, 5, "auto"))
    cases.append(("k_above_tile_width", rng.integers(0, 3, (8, 100)).astype(np.float32), 50, "auto"))
    for l in (10007, 1001, 130):
        cases.append((f"ragged_{l}", rng.integers(0, 5, (7, l)).astype(np.float32), 6, "auto"))
    # tiles of 3, 3, 3 and 1 labels, k above every tile's width
    cases.append(("narrow_tiles", rng.random((5, 10), dtype=np.float32), 8, "kernel"))
    cases.append(("signed_zeros", signed_zero_rows(), 6, "auto"))
    cases.append(("signed_zeros_kernel", signed_zero_rows(), 6, "kernel"))
    cases.append(("prune", rng.random((4, 8192), dtype=np.float32), 5, "prune"))
    return cases


def k_past_labels_case():
    """k above the global label count: the columns past it are padding."""
    return np.random.default_rng(6).random((3, 6), dtype=np.float32), 8


def pair_data():
    rng = np.random.default_rng(15)
    x = rng.random(PAIR_SHAPE, dtype=np.float32)
    t = (rng.random(PAIR_SHAPE) > 0.9).astype(np.float32)
    return x, t


def row_sharded_data(shape):
    return np.random.default_rng(16 + shape[0]).random(shape, dtype=np.float32)


def retrieval_data(graded: bool):
    """``tests/metrics/test_retrieval.py``'s data at a label count that is
    not a multiple of 4, with one row that has no relevant label."""
    rng = np.random.default_rng(11 if graded else 12)
    shape = (RETRIEVAL_N, RETRIEVAL_L)
    s = rng.random(shape).astype(np.float32)
    t = (rng.random(shape) > 0.97).astype(np.float32)
    if graded:
        t = (t * rng.integers(1, 4, shape)).astype(np.float32)
    t[0] = 0.0
    return s, t


# ------------------------------------------------------------- scatter data
SCATTER_N, SCATTER_SEGMENTS = 500, 64
SHARDED_SUM_N, SHARDED_SUM_SEGMENTS = 300, 50
SKETCH_N, SKETCH_SLICES, SKETCH_BITS = 4000, 64, 4


def scatter_cases():
    """``(name, vals, rows, reduce, method)`` over one replicated stream;
    rows outside ``[0, 64)`` included."""
    rng = np.random.default_rng(17)
    n, s = SCATTER_N, SCATTER_SEGMENTS
    rows = rng.integers(-3, s + 3, n).astype(np.int32)
    f = rng.random(n).astype(np.float32)
    f_nan = f.copy()
    f_nan[::37] = np.nan
    return [
        ("sum_i32_d2", rng.integers(-5, 6, (n, 2)).astype(np.int32), rows, "sum", "auto"),
        ("sum_i64", rng.integers(-9, 9, n).astype(np.int64), rows, "sum", "auto"),
        ("sum_f32", f, rows, "sum", "auto"),
        ("sum_f32_tail", rng.random((n, 2, 3)).astype(np.float32), rows, "sum", "kernel"),
        ("sum_i32_torch", rng.integers(0, 7, (n, 4)).astype(np.int32), rows, "sum", "torch"),
        ("max_i32_d4", rng.integers(0, 7, (n, 4)).astype(np.int32), rows, "max", "auto"),
        ("min_i32_d4", rng.integers(0, 7, (n, 4)).astype(np.int32), rows, "min", "auto"),
        ("max_f32_nan", f_nan, rows, "max", "auto"),
        ("min_f32_tail", rng.random((n, 3)).astype(np.float32), rows, "min", "auto"),
    ]


def sharded_sum_shard(rank: int, dtype: str):
    rng = np.random.default_rng(300 + rank + (10 if dtype == "float32" else 0))
    n = SHARDED_SUM_N
    vals = (
        rng.integers(-4, 5, (n, 2)).astype(np.int32)
        if dtype == "int32"
        else rng.random((n, 2)).astype(np.float32)
    )
    rows = rng.integers(-2, SHARDED_SUM_SEGMENTS + 2, n).astype(np.int64)
    return vals, rows


def sketch_fold_data():
    rng = np.random.default_rng(19)
    n = SKETCH_N
    rows = rng.integers(0, SKETCH_SLICES, n).astype(np.int32)
    scores = (rng.standard_normal(n) * 4.0).astype(np.float32)
    scores[::53] = np.nan
    targets = (rng.random(n) < 0.4).astype(np.float32)
    return rows, scores, targets


# -------------------------------------------------------------- sliced data
def sliced_batches(n_unique: int, n_batches: int = 3, n: int = 4096, seed: int = 7):
    """``tests/metrics/test_sliced_sharded.py``'s batches."""
    rng = np.random.default_rng(seed)
    pool = np.arange(n_unique, dtype=np.int64) * 991 + 7
    out = []
    for _ in range(n_batches):
        ids = rng.choice(pool, n)
        scores = rng.random(n).astype(np.float32)
        targets = (rng.random(n) < 0.5).astype(np.float32)
        out.append((ids, scores, targets))
    return out


# ---------------------------------------------------------------- helpers
def _words(t) -> list:
    import torch

    return t.contiguous().view(torch.int32).tolist()


def _list(t) -> list:
    return np.asarray(t.detach().cpu() if hasattr(t, "detach") else t, np.float64).tolist()


def _raises(fn) -> str:
    """The message of the ValueError ``fn`` raises ('' when it does not)."""
    try:
        fn()
    except ValueError as err:
        return str(err) or "ValueError"
    return ""


# ------------------------------------------------------------ the scenarios
def run_topk(rank: int, world: int, outdir: str) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from torcheval_tpu_torch.metrics import MAP, NDCG, RecallAtK
    from torcheval_tpu_torch.metrics.functional import (
        map_at_k,
        ndcg_at_k,
        recall_at_k,
        retrieval_hit_rate,
    )
    from torcheval_tpu_torch.metrics.toolkit import get_synced_state_dict, sync_and_compute
    from torcheval_tpu_torch.ops.topk import sharded_label_topk, sharded_topk_kernel
    from torcheval_tpu_torch.parallel import block_bounds, data_parallel_mesh, label_tile, shard_batch
    from torcheval_tpu_torch.utils import dist as _dist

    res = {}
    # --- row-sharded: each rank its block of rows, no collective
    dp = data_parallel_mesh(device="cpu")
    for key, shape in (("row", ROW_SHARDED_SHAPE), ("row_uneven", ROW_SHARDED_UNEVEN)):
        before = (_dist.all_gather_stacked.calls, _dist.all_reduce_sum.calls)
        v, i = sharded_topk_kernel(shard_batch(dp, row_sharded_data(shape)), 5)
        res[key] = {"values": _words(v), "indices": i.tolist(),
                    "collectives": [_dist.all_gather_stacked.calls - before[0],
                                    _dist.all_reduce_sum.calls - before[1]]}
    v, i = sharded_topk_kernel(torch.from_numpy(row_sharded_data((16, 1536))), 3)
    res["row_replicated"] = {"values": _words(v), "indices": i.tolist()}

    # --- label-sharded on a 1-D mesh of the four ranks
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("label",))
    res["label"] = {}
    for name, x, k, method in label_cases():
        v, i = sharded_label_topk(label_tile(x, mesh, "label"), k, mesh=mesh, label_axis="label",
                                  method=method)
        res["label"][name] = {"values": _words(v), "indices": i.tolist()}
    x, k = k_past_labels_case()
    v, i = sharded_label_topk(label_tile(x, mesh, "label"), k, mesh=mesh, label_axis="label")
    res["k_past_labels"] = {"values": _words(v), "indices": i.tolist()}
    x, t = pair_data()
    v, i, g = sharded_label_topk(label_tile(x, mesh, "label"), 3, mesh=mesh, label_axis="label",
                                 gather=label_tile(t, mesh, "label"))
    res["gather"] = {"values": _words(v), "indices": i.tolist(), "gathered": _list(g)}
    before = _dist.all_gather_stacked.calls
    sharded_label_topk(label_tile(x, mesh, "label"), 3, mesh=mesh, label_axis="label")
    res["label_collectives"] = _dist.all_gather_stacked.calls - before
    res["unknown_axis"] = _raises(
        lambda: sharded_label_topk(torch.zeros(4, 16), 2, mesh=mesh, label_axis="lable"))

    # --- the retrieval metrics and functionals with label_mesh=
    lm = (mesh, "label")
    s, t = retrieval_data(graded=True)
    ts, tt = label_tile(s, mesh, "label"), label_tile(t, mesh, "label")
    res["metrics"] = {}
    for name, make in (("ndcg", NDCG), ("map", MAP), ("recall", RecallAtK)):
        for method in ("auto", "kernel"):
            m = make(k=RETRIEVAL_K, topk_method=method, label_mesh=lm, device="cpu")
            for b in range(0, RETRIEVAL_N, RETRIEVAL_BATCH):
                m.update(ts[b : b + RETRIEVAL_BATCH], tt[b : b + RETRIEVAL_BATCH])
            res["metrics"][f"{name}_{method}"] = {
                "value": float(m.compute()), "num_valid": int(m.num_valid)}
    res["functional"] = {}
    for fname, fn in (("recall", recall_at_k), ("map", map_at_k), ("ndcg", ndcg_at_k),
                      ("hit_rate", retrieval_hit_rate)):
        for k in (RETRIEVAL_K, None, RETRIEVAL_L + 99):
            res["functional"][f"{fname}_{k}"] = _list(fn(ts, tt, k=k, label_mesh=lm))
    res["bad_label_mesh"] = [
        _raises(lambda: NDCG(k=3, label_mesh=(mesh, "nope"), device="cpu")),
        _raises(lambda: NDCG(k=3, label_mesh=(mesh,), device="cpu")),
        _raises(lambda: ndcg_at_k(ts, tt, k=3, label_mesh=(mesh, "label", "label"))),
    ]

    # --- a 2 x 2 ("data", "label") mesh: rows split over "data", labels
    # over "label"; the metric state is the same on both label ranks, so
    # it syncs over the data ranks only
    mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "label"))
    d = _dist.mesh_axis(mesh2, "data")
    data_ranks = dist.get_process_group_ranks(d.group)
    s, t = retrieval_data(graded=False)
    lo, hi = block_bounds(RETRIEVAL_N, d.size, d.rank)
    rs, rt = label_tile(s[lo:hi], mesh2, "label"), label_tile(t[lo:hi], mesh2, "label")
    v, i = sharded_label_topk(rs, 7, mesh=mesh2, label_axis="label")
    res["mesh2"] = {"rows": [lo, hi], "values": _words(v), "indices": i.tolist(),
                    "data_ranks": data_ranks}
    m = RecallAtK(k=RETRIEVAL_K, label_mesh=(mesh2, "label", "data"), device="cpu")
    for b in range(0, hi - lo, RETRIEVAL_BATCH // 2):
        m.update(rs[b : b + RETRIEVAL_BATCH // 2], rt[b : b + RETRIEVAL_BATCH // 2])
    res["mesh2"]["local"] = float(m.compute())
    res["mesh2"]["synced"] = float(sync_and_compute(m, recipient_rank="all", processes=data_ranks))
    res["mesh2"]["num_valid_data_sync"] = int(
        get_synced_state_dict(m, recipient_rank="all", processes=data_ranks)["num_valid"])
    res["mesh2"]["num_valid_world_sync"] = int(
        get_synced_state_dict(m, recipient_rank="all")["num_valid"])
    return res


def run_scatter(rank: int, world: int, outdir: str) -> dict:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from torcheval_tpu_torch.ops.scatter import segment_scatter, sharded_segment_sum
    from torcheval_tpu_torch.sketch.cache import sliced_score_hist_fold
    from torcheval_tpu_torch.utils import dist as _dist

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("slices",))
    res = {"tiles": {}}
    for name, vals, rows, reduce, method in scatter_cases():
        before = (_dist.all_gather_stacked.calls, _dist.all_reduce_sum.calls)
        out = segment_scatter(torch.from_numpy(vals), torch.from_numpy(rows), SCATTER_SEGMENTS,
                              reduce=reduce, method=method, mesh=mesh, axis="slices")
        res["tiles"][name] = {
            "shape": list(out.shape), "dtype": str(out.dtype), "values": out.tolist(),
            "collectives": [_dist.all_gather_stacked.calls - before[0],
                            _dist.all_reduce_sum.calls - before[1]]}
    res["uneven"] = _raises(lambda: segment_scatter(
        torch.zeros(4, 2), torch.zeros(4, dtype=torch.int32), 66, mesh=mesh, axis="slices"))
    res["mesh_without_axis"] = _raises(lambda: segment_scatter(
        torch.zeros(4, 2), torch.zeros(4, dtype=torch.int32), 64, mesh=mesh))
    res["sharded_sum"] = {}
    for dtype in ("int32", "float32"):
        vals, rows = sharded_sum_shard(rank, dtype)
        out = sharded_segment_sum(torch.from_numpy(vals), torch.from_numpy(rows),
                                  SHARDED_SUM_SEGMENTS)
        res["sharded_sum"][dtype] = {"dtype": str(out.dtype), "values": out.tolist()}
    rows, scores, targets = sketch_fold_data()
    hist = sliced_score_hist_fold(torch.from_numpy(rows), torch.from_numpy(scores),
                                  torch.from_numpy(targets), SKETCH_BITS, SKETCH_SLICES,
                                  shard=_dist.mesh_axis(mesh, "slices"))
    res["sketch_fold"] = {k: v.tolist() for k, v in hist.items()}
    return res


def _sliced(sharded, slice_mesh, capacity=8, agg=False, **kw):
    from torcheval_tpu_torch.metrics import (
        BinaryAccuracy,
        BinaryAUROC,
        Max,
        Mean,
        SlicedMetricCollection,
    )

    members = ({"mean": Mean(device="cpu"), "max": Max(device="cpu")} if agg else
               {"acc": BinaryAccuracy(device="cpu"), "auroc": BinaryAUROC(approx=1024, device="cpu")})
    mesh_kw = {"mesh": slice_mesh, "mesh_axis": "slices"} if sharded else {}
    return SlicedMetricCollection(members, capacity=capacity, **mesh_kw, **kw)


def _feed(col, batches, agg=False):
    for ids, s, t in batches:
        if agg:
            col.update(ids, s)
        else:
            col.update(ids, s, t)
    return col


def _values(col) -> dict:
    out = col.compute()
    first = next(iter(out.values()))
    res = {"ids": [int(i) for i in first.slice_ids]}
    for name, r in out.items():
        res[name] = _list(r["values"])
    return res


def _save_states(path: str, col, write: bool) -> None:
    """Every rank gathers the state dicts (a collective); one writes them."""
    from torcheval_tpu_torch.utils.jax_state import numpy_state_dicts

    flat = {f"{m}/{k}": v for m, sd in numpy_state_dicts(col).items() for k, v in sd.items()}
    if write:
        np.savez(path, **flat)


def load_states(path: str) -> dict:
    """``{member: {state: array}}`` of a file :func:`_save_states` wrote
    (or one the test wrote in the same layout)."""
    with np.load(path) as f:
        out: dict = {}
        for key in f.files:
            member, state = key.split("/", 1)
            out.setdefault(member, {})[state] = f[key]
    return out


def _tile_rows(col) -> dict:
    rows = {}
    for name, m in col.metrics.items():
        m._fold_now()
        rows[name] = {s: int(getattr(m, s).shape[0]) for s in m._sliced_state_names}
        rows[name]["slice_ids_hi"] = int(m.slice_ids_hi.shape[0])
    return rows


def run_sliced(rank: int, world: int, outdir: str) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from torcheval_tpu_torch.utils.jax_state import load_jax_state_dicts

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("slices",))
    res = {}
    for key, n_unique, capacity in (("small", 8, 8), ("growth", 2500, 2048)):
        col = _feed(_sliced(True, mesh, capacity), sliced_batches(n_unique))
        res[key] = _values(col)
        res[key]["capacity"] = col.slice_table.capacity
    col = _feed(_sliced(True, mesh, 64), sliced_batches(48))
    res["tile_rows"] = _tile_rows(col)
    res["capacity_rounded"] = _sliced(True, mesh, 3).slice_table.capacity
    other = init_device_mesh("cpu", (world,), mesh_dim_names=("cohorts",))
    res["validation"] = [
        _raises(lambda: _sliced(False, None, mesh=other)),
        _raises(lambda: _sliced(False, None, mesh=other, mesh_axis="nope")),
        _raises(lambda: _sliced(False, None, mesh_axis="cohorts")),
    ]
    explicit = _sliced(False, None, mesh=other, mesh_axis="cohorts")
    res["explicit_mesh"] = _values(_feed(explicit, sliced_batches(8, n_batches=1)))

    batches = sliced_batches(40, n_batches=4)
    a = _feed(_sliced(True, mesh), batches[:2])
    b = _feed(_sliced(True, mesh), batches[2:])
    res["merge"] = _values(a.merge_collections([b]))
    plain_b = _feed(_sliced(False, None), batches[2:])
    a = _feed(_sliced(True, mesh), batches[:2])
    res["merge_plain_source"] = _values(a.merge_collections([plain_b]))

    batches = sliced_batches(24)
    col = _feed(_sliced(True, mesh), batches)
    col.compute()
    col.reset()
    res["reset"] = _values(_feed(col, batches))
    col = _feed(_sliced(True, mesh), batches)
    want = _values(col)
    clone = copy.deepcopy(col)
    res["deepcopy"] = _values(clone)
    res["deepcopy_before"] = want
    res["deepcopy_shares_mesh"] = clone._slice_shard is col._slice_shard and all(
        m._shard is col._slice_shard for m in clone.metrics.values())
    res["deepcopy_tile_rows"] = _tile_rows(clone)

    # state dicts: the unsharded layout, loaded back sharded and unsharded
    col = _feed(_sliced(True, mesh), batches)
    plain = _sliced(False, None)
    plain.load_state_dicts(col.state_dicts())
    res["to_plain"] = _values(plain)
    back = _sliced(True, mesh)
    back.load_state_dicts(plain.state_dicts())
    res["back_to_sharded"] = _values(back)
    res["back_tile_rows"] = _tile_rows(back)
    _save_states(os.path.join(outdir, "port_state.npz"), col, rank == 0)
    # a JAX collection's state (capacity 24: not a multiple of 4 ranks)
    from_jax = _sliced(True, mesh)
    load_jax_state_dicts(from_jax, load_states(os.path.join(outdir, "jax_state.npz")))
    res["from_jax"] = _values(from_jax)
    res["from_jax_capacity"] = from_jax.slice_table.capacity
    extra = sliced_batches(30, n_batches=1, seed=8)
    _feed(from_jax, extra)
    res["from_jax_streamed"] = _values(from_jax)
    _save_states(os.path.join(outdir, "port_state_streamed.npz"), from_jax, rank == 0)

    # Mean and Max: the masked extremum route; update_placed
    agg_batches = sliced_batches(300, n_batches=3, seed=9)
    res["agg_sharded"] = _values(_feed(_sliced(True, mesh, 64, agg=True), agg_batches, agg=True))
    res["agg_plain"] = _values(_feed(_sliced(False, None, 64, agg=True), agg_batches, agg=True))
    placed = _sliced(True, mesh)
    for ids, s, t in batches:
        placed.update_placed((ids, s, t))
    res["update_placed"] = _values(placed)

    # the sketch member's extent bound is per shard
    planes = 2 * 1024 + 1
    bound = (2**31 - 1) // planes
    plain_m = _sliced(False, None).metrics["auroc"]
    sharded_m = _sliced(True, mesh).metrics["auroc"]
    res["extent"] = [
        _raises(lambda: plain_m._check_capacity(world * bound)),
        _raises(lambda: sharded_m._check_capacity(world * bound)),
        _raises(lambda: sharded_m._check_capacity(world * (bound + 1))),
    ]
    return res


SCENARIOS = {"topk": run_topk, "scatter": run_scatter, "sliced": run_sliced}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch_world(scenario: str, outdir: str, timeout_s: float) -> list:
    """Run the ``WORLD`` workers of ``scenario`` and return each rank's
    results. Every worker is killed at ``timeout_s``, so a hung collective
    cannot hang the caller; a failed rank raises ``AssertionError`` with
    every rank's output. A second port is tried only when the first was
    taken between choosing and binding it."""
    try:
        return _launch_once(scenario, outdir, timeout_s)
    except AssertionError as err:
        if "address already in use" not in str(err).lower():
            raise
        return _launch_once(scenario, outdir, timeout_s)


def _launch_once(scenario: str, outdir: str, timeout_s: float) -> list:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(name, None)
    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "torcheval_tpu_torch.utils.test_utils.sharded_worker",
             scenario, str(r), str(WORLD), port, outdir],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(WORLD)
    ]
    deadline = time.monotonic() + timeout_s
    outs, timed_out = [], False
    for p in procs:
        try:
            out = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0]
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                q.kill()
            out = p.communicate()[0]
        outs.append(out.decode(errors="replace"))
    for r, (p, out) in enumerate(zip(procs, outs)):
        if timed_out or p.returncode != 0:
            logs = "\n".join(f"--- rank {i}:\n{o[-3000:]}" for i, o in enumerate(outs))
            raise AssertionError(
                f"the {scenario} world failed (rank {r} exit {p.returncode}, timed out: "
                f"{timed_out}):\n{logs}"
            )
    results = []
    for r in range(WORLD):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def main() -> None:
    scenario, rank, world, port, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    os.environ.update(
        MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(world), RANK=str(rank)
    )
    from torcheval_tpu_torch.parallel import init_from_env, shutdown

    got = init_from_env(device="cpu")
    assert got == (rank, world), got
    res = SCENARIOS[scenario](rank, world, outdir)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    shutdown()


if __name__ == "__main__":
    main()
