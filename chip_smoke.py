#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc``; it builds the CUDA kernels from
``torcheval_tpu_torch/csrc`` on first use. It exits non-zero, printing no
result, when CUDA is not available or the package is missing, and on any
failed check. Phases:

1. device: the card's name and power limit, CUDA version, kernel build time;
2. kernels against their plain PyTorch versions, on the card, at the main
   path's shapes and at edge cases (the top-k kernel also against the dense
   route, a stable sort), and at the shapes the deferred windows give them:
   the segment sum at the sliced leg's window, (2^24, 2) int32 and float32
   into 10^6 cohorts, and the histogram at the small-batch leg's window,
   1,638,400 labels into 10 bins;
3. headline leg: ``MulticlassAccuracy(num_classes=5)`` and
   ``BinaryAUROC(compaction_threshold=6 * 2**24)`` over 16 chunks of 2^24
   predictions, checked against an uncompacted ``BinaryAUROC`` and a direct
   count, plus a small stream checked against float64 numpy references;
4. macro leg: ``MulticlassAccuracy(average="macro", num_classes=1000)`` over
   8 chunks of 2^22 rows, checked against the plain histogram;
   small-batch leg (BASELINE config 1, ``bench.py:498-553``, with distinct
   batches): a ``MetricCollection`` of ``MulticlassAccuracy(num_classes=5)``
   and macro ``MulticlassF1Score(num_classes=5)`` over 200 batches of
   (8192, 5) scores, which fold in one window; the counts checked exactly
   against ``torch.bincount``'s over all batches, the values within rtol
   1e-5; and, as information, a standalone ``MulticlassAccuracy`` over the
   same stream (config 1 itself);
   top-k leg: ``TopKMultilabelAccuracy(k=5, criteria="contain")`` over 4
   batches of (8192, 10000) scores, every criterion's counts checked
   against the plain top-k and the first 64 rows against a float64 numpy
   reference;
   retrieval leg: ``NDCG(k=10)`` and ``NDCG(k=100)`` over 4 batches of
   (64, 1,000,000) scores, checked against the dense (sorting) route;
   sliced leg: ``SlicedMetricCollection`` over 1,000,000 cohorts with
   power-law traffic, one registration batch and 16 batches of 1,048,576
   rows, ``{"acc": BinaryAccuracy()}`` and ``{"mean": Mean(), "max": Max()}``,
   checked per cohort against numpy (counts and maxima exactly, means within
   rtol 1e-5);
   data-parallel leg: two ranks on the one card (processes this script
   spawns, joined over gloo, since NCCL refuses two ranks on one GPU), each
   feeding its 4 of 8 chunks of 2^24 predictions to a ``ShardedEvaluator``
   of ``MulticlassAccuracy(num_classes=5)`` and macro
   ``MulticlassF1Score(num_classes=5)`` and one of
   ``BinaryAUROC(compaction_threshold=3 * 2**24)``; ``compute()`` syncs the
   states over the ranks, and the synced results are checked against one
   process over all 8 chunks without the port's kernels (counts by
   ``torch.bincount``, exactly; AUROC uncompacted, within rtol 1e-5), and
   the compaction kernel against its plain version at every fold size the
   ranks ran; then a world of one rank over NCCL, through ``init_from_env``, runs the
   sharded class counts (one histogram launch and one NCCL all_reduce);
5. one JSON line per the kernels: launches on the main path (phases 3 and
   4, the data-parallel ranks' included), time per launch, the plain
   version's and a library call's time, and the least time the card could
   take (its bound); the segment sum also at the sliced leg's window.

Every leg prints its fold cadence: the window steps and the solo folds of
``metrics/deferred.py`` that it ran, and the batches each folded.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HEADLINE_CHUNK = 1 << 24
HEADLINE_CHUNKS = 16
HEADLINE_CLASSES = 5
THRESHOLD = 6 * HEADLINE_CHUNK
MACRO_CLASSES = 1000
MACRO_CHUNK = 1 << 22
MACRO_CHUNKS = 8
# BASELINE config 4 (bench.py:735-827) and config 6 (bench.py:1779-1818)
TOPK_ROWS, TOPK_LABELS, TOPK_K, TOPK_BATCHES = 8192, 10_000, 5, 4
RETRIEVAL_ROWS, RETRIEVAL_LABELS, RETRIEVAL_BATCHES = 64, 1_000_000, 4
RETRIEVAL_KS = (10, 100)
# bench.py::config11_sliced (bench.py:2008-2117): a million cohorts, power-law
# traffic; its BinaryAUROC(approx=1024) member needs the unported sketch mode
SLICED_COHORTS, SLICED_ROWS, SLICED_BATCHES = 1_000_000, 1 << 20, 16
SLICED_ZIPF = 1.3
# the data-parallel leg: the headline's data, 8 chunks over 2 ranks
DP_RANKS, DP_CHUNKS = 2, 8
DP_THRESHOLD = 3 * HEADLINE_CHUNK
DP_TIMEOUT_S = 600
# BASELINE config 1 (bench.py:498-553): 200 batches of (8192, 5) scores
SMALL_ROWS, SMALL_CLASSES, SMALL_BATCHES = 8192, 5, 200
TARGET_DENSITY = 1e-3
CRITERIA = ("exact_match", "hamming", "overlap", "contain", "belong")
# H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
RTOL, ATOL = 1e-5, 1e-8
# unit roundoff of the half types
HALF_U = {torch.bfloat16: 2.0**-8, torch.float16: 2.0**-11}
# 1 GiB: more than the 50 MB L2, and about 0.3 ms of device work, which also
# covers the host's time to enqueue the timed call, so that a time is the
# card's and not the wrapper's
L2_FLUSH_BYTES = 1 << 30


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= ATOL + RTOL * abs(b)


def fold_counts():
    """The deferred folds' counters: window steps, those that folded
    batches, their batches, solo and group folds, their batches (zeros for
    a package without windows)."""
    from torcheval_tpu_torch.metrics import deferred

    ws = getattr(deferred, "window_step", None)
    fp = getattr(deferred, "fold_pending", None)
    return (
        getattr(ws, "calls", 0), getattr(ws, "windows", 0), getattr(ws, "batches", 0),
        getattr(fp, "calls", 0), getattr(fp, "chunks", 0),
    )


def cadence(before) -> dict:
    keys = ("window_steps", "windows", "window_batches", "folds", "fold_batches")
    return dict(zip(keys, (a - b for a, b in zip(fold_counts(), before))))


def cadence_text(c: dict) -> str:
    folded = c["windows"] + c["folds"]
    batches = c["window_batches"] + c["fold_batches"]
    per = f"{batches / folded:.2f}" if folded else "-"
    return (f"window steps {c['window_steps']} ({c['windows']} folding "
            f"{c['window_batches']} batches), solo/group folds {c['folds']} "
            f"({c['fold_batches']} batches): {per} batches per fold")


class Timer:
    """Median CUDA-event time of ``fn`` per call, with L2 flushed before each
    (the flush also keeps the card busy while the host enqueues ``fn``)."""

    def __init__(self, dev: torch.device) -> None:
        self.flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def ms(self, fn, reps: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))


# ------------------------------------------------------------------ phase 2
def check_hist(dev, gen):
    """The kernel against its plain version, exactly: random labels (out of
    range on both sides) at the legs' class counts (the headline's C and
    the 2C bins of F1's joint key at its chunk size), and at the macro
    leg's size every label equal, a ragged length and views off a 16-byte
    boundary."""
    from torcheval_tpu_torch.ops.hist import hist, hist_plain

    def cases():
        for n, c in ((HEADLINE_CHUNK, HEADLINE_CLASSES), (HEADLINE_CHUNK, 2 * HEADLINE_CLASSES),
                     (MACRO_CHUNK, MACRO_CLASSES), (1 << 20, 20000),
                     (SMALL_BATCHES * SMALL_ROWS, 2 * SMALL_CLASSES)):
            for dtype in (torch.int32, torch.int64):
                yield (f"n={n} C={c} {str(dtype)[6:]}",
                       torch.randint(-3, c + 3, (n,), generator=gen, device=dev, dtype=dtype), c)
        for c in (1, HEADLINE_CLASSES, MACRO_CLASSES):
            yield f"n={MACRO_CHUNK} C={c} every label equal", torch.full((MACRO_CHUNK,), c - 1, device=dev), c
        ragged = torch.randint(-3, MACRO_CLASSES + 3, (MACRO_CHUNK + 3,), generator=gen, device=dev)
        for offset in (0, 1, 3):
            yield (f"n={MACRO_CHUNK + 3 - offset} C={MACRO_CLASSES} view at +{offset} labels",
                   ragged[offset:], MACRO_CLASSES)
            yield (f"n={MACRO_CHUNK + 3 - offset} C={MACRO_CLASSES} int32 view at +{offset} labels",
                   ragged.to(torch.int32)[offset:], MACRO_CLASSES)

    worst = 0
    for name, labels, c in cases():
        got, want = hist(labels, c), hist_plain(labels, c)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want).abs().max())
        worst = max(worst, err)
        _require(err == 0 and int(got.sum()) == int(((labels >= 0) & (labels < c)).sum()),
                 f"hist {name}")
        print(f"  hist {name}: exact")
    return float(worst)


def _special_scores(n, dev, gen):
    s = torch.rand(n, generator=gen, device=dev)
    idx = torch.randint(0, n, (6, max(n // 1000, 1)), generator=gen, device=dev)
    for row, v in zip(idx, (float("nan"), float("inf"), float("-inf"), -0.0, 0.0, float("nan"))):
        s[row] = v
    return s


def check_compaction(dev, gen, sizes=(THRESHOLD, THRESHOLD - 12345)):
    """The kernel against its plain version, bit for bit, at each of
    ``sizes`` rows (the headline's fold by default; the data-parallel leg
    passes the fold sizes its ranks ran), NaN and +-inf/+-0.0 among the
    scores, at four mask densities."""
    from torcheval_tpu_torch.ops.stream_compact import (
        compact_summary_rows,
        compact_summary_rows_plain,
    )

    worst = 0
    for n in sizes:
        s = _special_scores(n, dev, gen)
        tp = torch.randint(0, 2**31 - 1, (n,), generator=gen, device=dev, dtype=torch.int32)
        fp = torch.randint(0, 2**31 - 1, (n,), generator=gen, device=dev, dtype=torch.int32)
        for density in (0.0, 1e-3, 0.5, 1.0):
            keep = torch.rand(n, generator=gen, device=dev) < density
            got = compact_summary_rows(s, tp, fp, keep)
            want = compact_summary_rows_plain(s, tp, fp, keep)
            torch.cuda.synchronize()
            _require(int(got[3]) == int(want[3]) == int(keep.sum()), f"n_live n={n} d={density}")
            pairs = [(got[0].view(torch.int32), want[0].view(torch.int32)), (got[1], want[1]), (got[2], want[2])]
            for g, w in pairs:
                err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                worst = max(worst, err)
                _require(err == 0, f"compact_summary_rows n={n} density={density}")
            print(f"  compact_summary_rows n={n} density={density}: n_live={int(got[3])}, bit-equal")
    return float(worst)


def check_compact_counts(dev, gen, scores, targets):
    from torcheval_tpu_torch.ops.summary import compact_counts, compact_counts_fast

    tie = (_special_scores(1 << 22, dev, gen) * 512).floor() / 512
    tie_t = (torch.rand(1 << 22, generator=gen, device=dev) < 0.3).to(torch.int32)
    cases = {"ties+specials": (tie, tie_t), "first fold": (scores, targets)}
    for name, (s, t) in cases.items():
        t = t.to(torch.int32)
        a = compact_counts(s, t, 1 - t)
        b = compact_counts_fast(s, t, 1 - t)
        torch.cuda.synchronize()
        for i in range(1, 5):
            _require(torch.equal(a[i], b[i]), f"{name}: output {i}")
        # live rows bit for bit; padding by isnan (NaN payload bits are not
        # part of the contract: the two-sort path negates its NaN keys)
        nl = int(a[3])
        _require(torch.equal(a[0][:nl].view(torch.int32), b[0][:nl].view(torch.int32)),
                 f"{name}: live scores")
        _require(bool(torch.isnan(a[0][nl:]).all() and torch.isnan(b[0][nl:]).all()),
                 f"{name}: NaN padding")
        print(f"  compact_counts_fast == compact_counts ({name}, n={s.shape[0]}, "
              f"n_unique={nl}, nan_dropped={int(a[4])}): live rows bit-equal, padding NaN")


def _topk_cases(dev, gen):
    """(name, x, k): random rows at both legs' shapes, then ties, equal
    rows, float specials, ragged widths and the k edges."""
    def rand(n, l):
        return torch.rand((n, l), generator=gen, device=dev)

    def ties(n, l):
        return torch.randint(-3, 4, (n, l), generator=gen, device=dev).float()

    special = ties(64, 12345)
    special[0::4, ::3] = float("nan")
    special[0::4, 1::3] = -float("nan")
    special[1::4, ::2] = -0.0
    special[1::4, 1::2] = 0.0
    special[2::4, ::5] = float("inf")
    special[2::4, 1::5] = float("-inf")
    special[3::4] = float("-inf")
    special[3::4, 777] = float("nan")
    return [
        ("random 8192x10000", rand(TOPK_ROWS, TOPK_LABELS), TOPK_K),
        ("random 64x1000000 k=100", rand(RETRIEVAL_ROWS, RETRIEVAL_LABELS), 100),
        ("random 64x1000000 k=10", rand(RETRIEVAL_ROWS, RETRIEVAL_LABELS), 10),
        ("ideal ranking 64x1000000 k=100", (rand(RETRIEVAL_ROWS, RETRIEVAL_LABELS) < TARGET_DENSITY).float(), 100),
        ("all equal 64x1000000 k=100", torch.full((RETRIEVAL_ROWS, RETRIEVAL_LABELS), 0.5, device=dev), 100),
        ("all equal", torch.full((256, 10_000), 0.5, device=dev), 128),
        ("heavy ties", ties(1024, 10_000), 128),
        ("+-inf, +-0.0, +-NaN", special, 64),
        ("ragged L=12345 k=1", rand(300, 12345), 1),
        ("L=1025 k=128", ties(500, 1025), 128),
        ("k=L=128", ties(500, 128), 128),
        ("k=L=100", rand(500, 100), 100),
    ]


def check_topk(dev, gen):
    """The kernel against its plain version (the same radix select in torch
    ops) and against the dense route (a stable sort), bit for bit."""
    from torcheval_tpu_torch.ops.topk import topk, topk_kernel, topk_kernel_plain

    worst = 0.0
    for name, x, k in _topk_cases(dev, gen):
        v, i = topk_kernel(x, k)
        pv, pi = topk_kernel_plain(x, k)
        dv, di = topk(x, k, method="dense")
        torch.cuda.synchronize()
        for what, (wv, wi) in (("plain", (pv, pi)), ("dense", (dv, di))):
            _require(torch.equal(v.view(torch.int32), wv.view(torch.int32)) and torch.equal(i, wi),
                     f"topk {name} against {what}")
        both = torch.isfinite(v) & torch.isfinite(pv)
        worst = max(worst, float((v[both] - pv[both]).abs().max()) if bool(both.any()) else 0.0)
        print(f"  topk {name} {tuple(x.shape)} k={k}: bit-equal to the plain and dense routes")
    return worst


def _zipf_rows(rng, n, s):
    return (rng.zipf(SLICED_ZIPF, n) - 1) % s


def _segment_sum_cases(dev):
    """(name, vals, rows, S, exact): every value type, D in {1, 2, 3, 4, 7,
    130}, S in {1, 12288, 2^20 + 3}, rows uniform, power-law and out of
    range (negative and >= S), NaN and +-inf in the float columns, empty
    streams, and non-negative floats (``exact`` where every partial sum is
    exact); at the sliced leg's shape, (2^20, 2) into 10^6 cohorts, every
    row 0, uniform rows, values and rows as views off a 16-byte boundary,
    and bfloat16 and float16 values."""
    rng = np.random.default_rng(SEED)
    cases = []
    for dtype in (torch.int32, torch.int64, torch.float32, torch.float64):
        for d in (1, 2, 3, 4, 7, 130):
            n = {1: 1 << 20, 2: 1 << 20, 3: 1 << 18, 4: 1 << 18, 7: 1 << 17, 130: 1 << 14}[d]
            if dtype.is_floating_point:
                vals = torch.from_numpy(rng.standard_normal((n, d))).to(dev, dtype)
                vals[::997, 0] = float("nan")
                vals[1::991, -1] = float("inf")
                vals[2::983, -1] = float("-inf")
            else:
                big = 2**31 - 1 if dtype == torch.int32 else 2**62
                vals = torch.from_numpy(rng.integers(-big, big, (n, d))).to(dev, dtype)
            for s, kind in ((1, "uniform"), (12_288, "zipf"), (2**20 + 3, "uniform"),
                            (2**20 + 3, "out of range")):
                if kind == "uniform":
                    rows = rng.integers(0, s, n)
                elif kind == "zipf":
                    rows = _zipf_rows(rng, n, s)
                else:
                    rows = np.where(rng.random(n) < 0.5, _zipf_rows(rng, n, s), rng.integers(-5, s + 5, n))
                rows = torch.from_numpy(rows).to(dev)
                if kind == "zipf":
                    rows = rows.to(torch.int32)
                cases.append((f"{str(dtype)[6:]} D={d} S={s} {kind} rows", vals, rows, s, False))
        empty = torch.zeros((0, 3), dtype=dtype, device=dev)
        cases.append((f"{str(dtype)[6:]} N=0", empty, torch.zeros(0, dtype=torch.int64, device=dev), 5, False))
        if dtype.is_floating_point:
            n = 1 << 20
            # non-negative values: |sum| = sum|v|, so the bound is relative to
            # the sum; and multiples of 1/4 below 2, whose every partial sum
            # (under 2^24 quarters) is exact in any order, so a segment sum
            # that lost or doubled one sample cannot pass
            uniform = torch.from_numpy(rng.random((n, 2))).to(dev, dtype)
            quarters = torch.from_numpy(rng.integers(0, 8, (n, 2)) / 4).to(dev, dtype)
            for s in (1, 12_288):
                rows = torch.from_numpy(_zipf_rows(rng, n, s)).to(dev)
                cases.append((f"{str(dtype)[6:]} D=2 S={s} zipf rows, uniform [0, 1)", uniform, rows, s, False))
                cases.append((f"{str(dtype)[6:]} D=2 S={s} zipf rows, quarters in [0, 2)", quarters, rows, s, True))
    n, s = SLICED_ROWS, SLICED_COHORTS
    leg_rows = torch.from_numpy(_zipf_rows(rng, n + 3, s)).to(dev, torch.int32)
    for dtype in (torch.int32, torch.float32):
        vals = (torch.from_numpy(rng.integers(0, 2, (n + 3, 2))) if dtype == torch.int32
                else torch.from_numpy(rng.random((n + 3, 2)))).to(dev, dtype)
        name = f"{str(dtype)[6:]} D=2 S={s}"
        exact = dtype == torch.int32
        cases.append((f"{name} every row 0", vals[:n], torch.zeros(n, dtype=torch.int32, device=dev), s, exact))
        cases.append((f"{name} uniform rows", vals[:n], torch.from_numpy(rng.integers(0, s, n)).to(dev), s, exact))
        # the first two views admit no common 16-byte boundary (all scalar
        # loads); the third reaches one after one sample (a scalar head)
        for vo, ro in ((1, 0), (0, 1), (1, 3)):
            cases.append((f"{name} power-law rows, values view at +{vo}, rows view at +{ro}",
                          vals[vo:vo + n], leg_rows[ro:ro + n], s, exact))
    for dtype in (torch.bfloat16, torch.float16):
        vals = torch.from_numpy(rng.standard_normal((n, 2))).to(dev, dtype)
        cases.append((f"{str(dtype)[6:]} D=2 S={s} power-law rows", vals, leg_rows[:n], s, False))
    # the sliced leg's window: its 16 batches fold in one segment sum
    n = SLICED_BATCHES * SLICED_ROWS
    window_rows = torch.from_numpy(_zipf_rows(rng, n, s)).to(dev, torch.int32)
    for dtype in (torch.int32, torch.float32):
        vals = (torch.from_numpy(rng.integers(0, 2, (n, 2), dtype=np.int32)) if dtype == torch.int32
                else torch.from_numpy(rng.random((n, 2), dtype=np.float32))).to(dev)
        cases.append((f"{str(dtype)[6:]} D=2 S={s} power-law rows, the sliced window of {n} rows",
                      vals, window_rows, s, dtype == torch.int32))
    return cases


def check_segment_sum(dev):
    """The kernel against its plain version: integers, and floats whose
    partial sums are all exact, exactly; other floats within the module's
    bound of a float64 reference, (count - 1) * u * sum|v| per segment and
    lane (plus the reference's own), with NaN and +-inf where the reference
    has them; half-precision values, which add as float32 and are rounded
    once, within the float32 bound plus the half type's u times the float32
    sum, and compared with the plain float32 sum rounded the same way (the
    kernel sees float32 there, and the plain version's half-type adds are
    less exact). Returns the largest |kernel - plain| over finite entries
    of the kernel's own types."""
    from torcheval_tpu_torch.ops.scatter import segment_sum, segment_sum_plain

    worst = 0.0
    for name, vals, rows, s, exact in _segment_sum_cases(dev):
        half = vals.dtype in HALF_U
        got = segment_sum(vals, rows, s)
        want = (segment_sum_plain(vals.float(), rows, s).to(vals.dtype) if half
                else segment_sum_plain(vals, rows, s))
        torch.cuda.synchronize()
        _require(got.dtype == vals.dtype and got.shape == want.shape, f"segment_sum {name}: shape")
        if exact or not vals.dtype.is_floating_point:
            _require(torch.equal(got, want), f"segment_sum {name}")
            print(f"  segment_sum {name}: exact")
            continue
        ref = segment_sum_plain(vals.double(), rows, s)
        mag = segment_sum_plain(vals.double().abs(), rows, s)
        count = segment_sum_plain(torch.ones_like(rows, dtype=torch.float64), rows, s)[:, None]
        if half:
            adds = (count - 1).clamp(min=0) * (2.0**-24 + 2.0**-53) * mag
            bound = adds + HALF_U[vals.dtype] * (ref.abs() + adds)
        else:
            u = 2.0**-24 if vals.dtype == torch.float32 else 2.0**-53
            bound = (count - 1).clamp(min=0) * (u + 2.0**-53) * mag
        finite = torch.isfinite(ref)
        g = got.double()
        _require(torch.equal(torch.isnan(g), torch.isnan(ref))
                 and torch.equal(g[torch.isinf(ref)], ref[torch.isinf(ref)]),
                 f"segment_sum {name}: NaN and inf")
        err = (g - ref).abs()[finite]
        _require(bool((err <= bound[finite] + 1e-300).all()), f"segment_sum {name}: bound")
        both = torch.isfinite(got) & torch.isfinite(want)
        diff = float((got[both].double() - want[both].double()).abs().max()) if bool(both.any()) else 0.0
        if not half:
            worst = max(worst, diff)
        ratio = float((err / bound[finite].clamp(min=1e-300)).max()) if err.numel() else 0.0
        print(f"  segment_sum {name}: within the bound (largest error {ratio:.4f} of it); "
              f"|kernel - plain| <= {diff:.3e}")
        del ref, mag, count, bound
    return worst


# ------------------------------------------------------------------ phase 3
def headline_data(dev, gen):
    chunks = []
    for _ in range(HEADLINE_CHUNKS):
        scores = torch.rand((HEADLINE_CHUNK, HEADLINE_CLASSES), generator=gen, device=dev)
        labels = torch.randint(0, HEADLINE_CLASSES, (HEADLINE_CHUNK,), generator=gen, device=dev)
        logits = torch.rand((HEADLINE_CHUNK,), generator=gen, device=dev)
        chunks.append((scores, labels, logits, (labels == 0).to(torch.float32)))
    return chunks


def headline_leg(dev, chunks):
    from torcheval_tpu_torch.metrics import BinaryAUROC, MulticlassAccuracy

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    acc = MulticlassAccuracy(num_classes=HEADLINE_CLASSES, device=dev)
    auroc = BinaryAUROC(compaction_threshold=THRESHOLD, device=dev)
    for scores, labels, logits, binary in chunks:
        acc.update(scores, labels)
        auroc.update(logits, binary)
    acc_v, auroc_v = acc.compute(), auroc.compute()
    end.record()
    end.synchronize()
    host_seconds = time.perf_counter() - t0
    seconds = start.elapsed_time(end) / 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    return acc, float(acc_v), float(auroc_v), seconds, host_seconds, peak


def headline_reference(dev, chunks):
    from torcheval_tpu_torch.metrics import BinaryAUROC

    raw = BinaryAUROC(device=dev)
    correct = 0
    for scores, labels, logits, binary in chunks:
        raw.update(logits, binary)
        correct += int((scores.argmax(1) == labels).sum())
    return correct, float(raw.compute())


def _mann_whitney_auc(x, t):
    _, inv, counts = np.unique(x, return_inverse=True, return_counts=True)
    ends = np.cumsum(counts)
    ranks = ((ends - counts + 1 + ends) / 2.0)[inv]
    p = t.sum()
    n = t.size - p
    return (ranks[t == 1].sum() - p * (p + 1) / 2) / (p * n)


def _average_precision(x, t):
    uniq, inv = np.unique(-x, return_inverse=True)  # descending thresholds
    tp = np.bincount(inv, weights=t, minlength=uniq.size)
    fp = np.bincount(inv, weights=1 - t, minlength=uniq.size)
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    return float(np.sum(tp * ctp / (ctp + cfp)) / t.sum())


def small_reference_check(dev):
    from torcheval_tpu_torch.metrics import BinaryAUPRC, BinaryAUROC, MulticlassAccuracy

    rng = np.random.default_rng(SEED)
    n, chunk = 1 << 16, 1 << 12
    x = (np.floor(rng.random(n) * 512) / 512).astype(np.float32)
    t = (rng.random(n) < 0.3).astype(np.float32)
    scores = rng.random((n, HEADLINE_CLASSES)).astype(np.float32)
    labels = rng.integers(0, HEADLINE_CLASSES, n)
    auroc = BinaryAUROC(compaction_threshold=1 << 13, device=dev)
    auprc = BinaryAUPRC(compaction_threshold=1 << 13, device=dev)
    micro = MulticlassAccuracy(num_classes=HEADLINE_CLASSES, device=dev)
    macro = MulticlassAccuracy(average="macro", num_classes=HEADLINE_CLASSES, device=dev)
    for i in range(0, n, chunk):
        auroc.update(x[i:i + chunk], t[i:i + chunk])
        auprc.update(x[i:i + chunk], t[i:i + chunk])
        micro.update(scores[i:i + chunk], labels[i:i + chunk])
        macro.update(scores[i:i + chunk], labels[i:i + chunk])
    hit = scores.argmax(1) == labels
    per_class = [hit[labels == c].mean() for c in range(HEADLINE_CLASSES)]
    checks = {
        "auroc": (float(auroc.compute()), _mann_whitney_auc(x.astype(np.float64), t)),
        "auprc": (float(auprc.compute()), _average_precision(x.astype(np.float64), t)),
        "micro accuracy": (float(micro.compute()), float(hit.mean())),
        "macro accuracy": (float(macro.compute()), float(np.mean(per_class))),
    }
    for name, (got, want) in checks.items():
        _require(np.isfinite(got) and _close(got, want), f"small {name}: {got} vs {want}")
        print(f"  small stream {name}: {got:.8f} vs float64 numpy {want:.8f}")


# ------------------------------------------------------------------ phase 4
def macro_leg(dev, gen):
    from torcheval_tpu_torch.metrics import MulticlassAccuracy
    from torcheval_tpu_torch.ops.hist import hist_plain

    acc = MulticlassAccuracy(average="macro", num_classes=MACRO_CLASSES, device=dev)
    correct = torch.zeros(MACRO_CLASSES, dtype=torch.int64, device=dev)
    total = torch.zeros(MACRO_CLASSES, dtype=torch.int64, device=dev)
    update_ms = 0.0
    for _ in range(MACRO_CHUNKS):
        scores = torch.rand((MACRO_CHUNK, MACRO_CLASSES), generator=gen, device=dev)
        labels = torch.randint(0, MACRO_CLASSES, (MACRO_CHUNK,), generator=gen, device=dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        acc.update(scores, labels)
        b.record()
        b.synchronize()
        update_ms += a.elapsed_time(b)
        preds = scores.argmax(1)
        correct += hist_plain(torch.where(preds == labels, labels, -1), MACRO_CLASSES)
        total += hist_plain(labels, MACRO_CLASSES)
        del scores
    value = float(acc.compute())
    _require(torch.equal(acc.num_correct.to(torch.int64), correct), "macro num_correct")
    _require(torch.equal(acc.num_total.to(torch.int64), total), "macro num_total")
    return value, update_ms


def small_batch_data(dev, gen):
    """BASELINE config 1's shapes, 200 distinct batches made on the card."""
    return [
        (torch.rand((SMALL_ROWS, SMALL_CLASSES), generator=gen, device=dev),
         torch.randint(0, SMALL_CLASSES, (SMALL_ROWS,), generator=gen, device=dev))
        for _ in range(SMALL_BATCHES)
    ]


def small_batch_leg(dev, batches):
    """Accuracy and macro F1 in one collection, from the first ``update()``
    to both ``compute()`` results."""
    from torcheval_tpu_torch.metrics import MetricCollection, MulticlassAccuracy, MulticlassF1Score

    col = MetricCollection({
        "accuracy": MulticlassAccuracy(num_classes=SMALL_CLASSES, device=dev),
        "f1_macro": MulticlassF1Score(num_classes=SMALL_CLASSES, average="macro", device=dev),
    })
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for scores, labels in batches:
        col.update(scores, labels)
    out = col.compute()
    end.record()
    end.synchronize()
    return col, out, start.elapsed_time(end) / 1e3, time.perf_counter() - t0


def small_batch_standalone(dev, batches):
    """Config 1 itself: a standalone ``MulticlassAccuracy`` (information)."""
    from torcheval_tpu_torch.metrics import MulticlassAccuracy

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    acc = MulticlassAccuracy(num_classes=SMALL_CLASSES, device=dev)
    for scores, labels in batches:
        acc.update(scores, labels)
    value = float(acc.compute())
    end.record()
    end.synchronize()
    return value, start.elapsed_time(end) / 1e3


def check_small_batch(col, out, batches):
    """The counts exactly against ``torch.bincount``'s over all batches, the
    values within rtol 1e-5 of the values of those counts."""
    from torcheval_tpu_torch.metrics.functional.classification.f1_score import _f1_score_compute

    c = SMALL_CLASSES
    dev = batches[0][0].device
    correct, total = 0, 0
    tp, label, pred = (torch.zeros(c, dtype=torch.int64, device=dev) for _ in range(3))
    for scores, labels in batches:
        p = scores.argmax(1)
        hit = p == labels
        correct += int(hit.sum())
        total += labels.numel()
        tp += torch.bincount(labels[hit], minlength=c)
        label += torch.bincount(labels, minlength=c)
        pred += torch.bincount(p, minlength=c)
    acc_sd = col["accuracy"].state_dict()
    f1_sd = col["f1_macro"].state_dict()
    _require(int(acc_sd["num_correct"]) == correct and int(acc_sd["num_total"]) == total,
             f"small-batch accuracy counts {int(acc_sd['num_correct'])}/{int(acc_sd['num_total'])} "
             f"vs bincount {correct}/{total}")
    for name, want in (("num_tp", tp), ("num_label", label), ("num_prediction", pred)):
        _require(torch.equal(f1_sd[name].to(torch.int64), want), f"small-batch F1 {name}")
    f1_want = float(_f1_score_compute(tp.to(torch.int32), label.to(torch.int32),
                                      pred.to(torch.int32), "macro"))
    acc_v, f1_v = float(out["accuracy"]), float(out["f1_macro"])
    _require(_close(acc_v, correct / total) and _close(f1_v, f1_want),
             f"small-batch accuracy {acc_v} and F1 {f1_v} vs {correct / total} and {f1_want}")
    return acc_v, f1_v


def topk_leg_data(dev, gen):
    return [
        (torch.rand((TOPK_ROWS, TOPK_LABELS), generator=gen, device=dev),
         (torch.rand((TOPK_ROWS, TOPK_LABELS), generator=gen, device=dev) < TARGET_DENSITY).to(torch.int32))
        for _ in range(TOPK_BATCHES)
    ]


def topk_leg(dev, batches):
    from torcheval_tpu_torch.metrics import TopKMultilabelAccuracy

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    acc = TopKMultilabelAccuracy(k=TOPK_K, criteria="contain", device=dev)
    for scores, target in batches:
        acc.update(scores, target)
    value = float(acc.compute())
    end.record()
    end.synchronize()
    return acc, value, start.elapsed_time(end) / 1e3, torch.cuda.max_memory_allocated(dev)


def _numpy_topk_accuracy(scores, target, criteria):
    """float64 accuracy of a few rows: a stable descending sort on the
    total-order key of each float32 score."""
    b = scores.view(np.int32).astype(np.int64)
    key = b ^ ((b >> 31) & 0x7FFFFFFF)
    idx = np.argsort(-key, axis=1, kind="stable")[:, :TOPK_K]
    tgt = target != 0
    inter = np.take_along_axis(tgt, idx, axis=1).sum(1).astype(np.float64)
    t_count = tgt.sum(1).astype(np.float64)
    if criteria == "hamming":
        return float(np.mean(tgt.shape[1] - (TOPK_K + t_count - 2 * inter)) / tgt.shape[1])
    correct = {
        "exact_match": (inter == TOPK_K) & (t_count == TOPK_K),
        "overlap": inter > 0,
        "contain": inter == t_count,
        "belong": inter == TOPK_K,
    }[criteria]
    return float(np.mean(correct))


def check_topk_leg(dev, batches):
    from torcheval_tpu_torch.metrics import TopKMultilabelAccuracy
    from torcheval_tpu_torch.metrics.functional import topk_multilabel_accuracy
    from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
        _topk_multilabel_stats,
    )

    head_s = batches[0][0][:64]
    head_t = batches[0][1][:64]
    np_s, np_t = head_s.cpu().numpy(), head_t.cpu().numpy()
    for criteria in CRITERIA:
        m = TopKMultilabelAccuracy(k=TOPK_K, criteria=criteria, device=dev)
        correct = total = 0
        for scores, target in batches:
            m.update(scores, target)
            # the plain route: the dense top-k, a stable sort on the card
            c, t = _topk_multilabel_stats(scores, target, criteria, TOPK_K, "dense")
            correct, total = correct + int(c), total + int(t)
        sd = m.state_dict()
        _require(int(sd["num_correct"]) == correct and int(sd["num_total"]) == total,
                 f"top-k {criteria} counts {int(sd['num_correct'])}/{int(sd['num_total'])} vs plain "
                 f"{correct}/{total}")
        got = float(topk_multilabel_accuracy(head_s, head_t, criteria=criteria, k=TOPK_K))
        want = _numpy_topk_accuracy(np_s, np_t, criteria)
        _require(_close(got, want), f"top-k {criteria} first 64 rows {got} vs numpy {want}")
        print(f"  {criteria}: {int(sd['num_correct'])}/{int(sd['num_total'])} equal to the plain top-k; "
              f"first 64 rows {got:.8f} vs float64 numpy {want:.8f}")


def retrieval_leg_data(dev, gen):
    shape = (RETRIEVAL_ROWS, RETRIEVAL_LABELS)
    return [
        (torch.rand(shape, generator=gen, device=dev),
         (torch.rand(shape, generator=gen, device=dev) < TARGET_DENSITY).to(torch.float32))
        for _ in range(RETRIEVAL_BATCHES)
    ]


def retrieval_leg(dev, batches, k, topk_method="auto"):
    from torcheval_tpu_torch.metrics import NDCG

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ndcg = NDCG(k=k, topk_method=topk_method, device=dev)
    for scores, target in batches:
        ndcg.update(scores, target)
    value = float(ndcg.compute())
    end.record()
    end.synchronize()
    return ndcg, value, start.elapsed_time(end) / 1e3


def sliced_leg_data(dev, gen):
    """``bench.py:2039-2047``, seeded: every cohort once (registration), then
    power-law traffic, ids made sparse by ``id * 7919 + 13``; scores and
    targets on the card, ids on the host (interning needs host bytes)."""
    rng = np.random.default_rng(SEED)
    total = SLICED_ROWS * (SLICED_BATCHES + 1)
    zipf = _zipf_rows(rng, total, SLICED_COHORTS)
    base = np.concatenate([np.arange(SLICED_COHORTS), zipf])[:total]
    ids = base.astype(np.int64) * 7919 + 13
    scores = torch.rand(total, generator=gen, device=dev)
    targets = (torch.rand(total, generator=gen, device=dev) < 0.4).to(torch.float32)
    return ids, scores, targets


def _sliced_batch(data, i):
    ids, scores, targets = data
    sl = slice(i * SLICED_ROWS, (i + 1) * SLICED_ROWS)
    return ids[sl], scores[sl], targets[sl]


def sliced_setup(dev, data):
    """Both collections, with every cohort registered by batch 0."""
    from torcheval_tpu_torch.metrics import BinaryAccuracy, Max, Mean, SlicedMetricCollection

    acc = SlicedMetricCollection({"acc": BinaryAccuracy(device=dev)}, capacity=SLICED_COHORTS)
    agg = SlicedMetricCollection({"mean": Mean(device=dev), "max": Max(device=dev)},
                                 capacity=SLICED_COHORTS)
    ids, s, t = _sliced_batch(data, 0)
    acc.update(ids, s, t)
    agg.update(ids, s)
    acc.state_dicts(), agg.state_dicts()  # the registration batch folds here
    torch.cuda.synchronize()
    return acc, agg


def sliced_epoch(dev, data, acc, agg):
    """The timed epoch: 16 batches into both collections, from the first
    ``update()`` to both ``compute()`` results."""
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for i in range(1, SLICED_BATCHES + 1):
        ids, s, t = _sliced_batch(data, i)
        acc.update(ids, s, t)
        agg.update(ids, s)
    results = {**acc.compute(), **agg.compute()}
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    return results, start.elapsed_time(end) / 1e3, wall, torch.cuda.max_memory_allocated(dev)


def interning_seconds(table, data):
    """Host seconds per batch of one collection's steady-state interning
    (every cohort registered), measured apart from the device."""
    t0 = time.perf_counter()
    for i in range(1, SLICED_BATCHES + 1):
        table.intern(_sliced_batch(data, i)[0])
    return (time.perf_counter() - t0) / SLICED_BATCHES


def unsliced_leg(dev, data):
    """The same 16 batches through plain ``MetricCollection``s (no cohort
    axis), for the ratio only."""
    from torcheval_tpu_torch.metrics import BinaryAccuracy, Max, Mean, MetricCollection

    acc = MetricCollection({"acc": BinaryAccuracy(device=dev)})
    agg = MetricCollection({"mean": Mean(device=dev), "max": Max(device=dev)})
    _, s, t = _sliced_batch(data, 0)
    acc.update(s, t)
    agg.update(s)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(1, SLICED_BATCHES + 1):
        _, s, t = _sliced_batch(data, i)
        acc.update(s, t)
        agg.update(s)
    acc.compute(), agg.compute()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def check_sliced_leg(data, acc, agg, results):
    """Per cohort, against numpy over all 17 batches: the slice ids in
    first-seen order, num_correct and num_total exactly, the maxima exactly,
    the means within rtol 1e-5 of float64."""
    ids, scores, targets = data
    s, t = scores.cpu().numpy(), targets.cpu().numpy()
    uniq, first, inv = np.unique(ids, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    row_of = np.empty(uniq.shape[0], np.int64)
    row_of[order] = np.arange(uniq.shape[0])
    rows = row_of[inv.reshape(-1)]
    n = uniq.shape[0]
    _require(np.array_equal(results["acc"].slice_ids, uniq[order]), "slice ids in first-seen order")
    correct = ((s >= 0.5).astype(np.float32) == t)
    want_correct = np.bincount(rows, weights=correct, minlength=n).astype(np.int64)
    want_total = np.bincount(rows, minlength=n).astype(np.int64)
    member = acc.metrics["acc"]
    _require(np.array_equal(member.num_correct[:n].cpu().numpy(), want_correct), "per-cohort num_correct")
    _require(np.array_equal(member.num_total[:n].cpu().numpy(), want_total), "per-cohort num_total")
    want_max = np.full(n, -np.inf, np.float32)
    np.maximum.at(want_max, rows, s)
    _require(np.array_equal(results["max"]["values"].cpu().numpy(), want_max), "per-cohort max")
    want_mean = np.bincount(rows, weights=s.astype(np.float64), minlength=n) / want_total
    got_mean = results["mean"]["values"].cpu().numpy().astype(np.float64)
    # a cohort whose scores are all exactly 0.0 (torch.rand can draw it)
    # has mean 0 and must get exactly 0
    err = np.abs(got_mean - want_mean)
    rel = np.divide(err, np.abs(want_mean), out=np.where(err == 0, 0.0, np.inf), where=want_mean != 0)
    _require(bool(np.all(rel <= RTOL)), f"per-cohort mean (largest relative error {rel.max():.3e})")
    acc_v = results["acc"]["values"].cpu().numpy()
    _require(bool(np.all(np.isfinite(acc_v))) and acc_v.shape == (n,), "accuracy values finite")
    return float(rel.max())


# ------------------------------------------------ phase 4, data-parallel leg
def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dp_chunk(dev, i):
    """Chunk ``i`` of the data-parallel leg, the same in every process."""
    g = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
    scores = torch.rand((HEADLINE_CHUNK, HEADLINE_CLASSES), generator=g, device=dev)
    labels = torch.randint(0, HEADLINE_CLASSES, (HEADLINE_CHUNK,), generator=g, device=dev)
    logits = torch.rand((HEADLINE_CHUNK,), generator=g, device=dev)
    return scores, labels, logits, (labels == 0).to(torch.float32)


def dp_worker(rank: int, port: str) -> int:
    """One rank of the data-parallel leg (``chip_smoke.py --dp-rank R
    PORT``): its block of the chunks through two ``ShardedEvaluator``s on
    ``cuda:0``, synced over gloo; prints one ``DP_RESULT`` JSON line."""
    import torch.distributed as dist

    from torcheval_tpu_torch.metrics import BinaryAUROC, MulticlassAccuracy, MulticlassF1Score
    from torcheval_tpu_torch.metrics import toolkit
    from torcheval_tpu_torch.ops import stream_compact as stream_compact_module
    from torcheval_tpu_torch.ops.hist import hist
    from torcheval_tpu_torch.ops.stream_compact import stream_compact
    from torcheval_tpu_torch.parallel import (
        ShardedEvaluator,
        data_parallel_mesh,
        init_from_env,
        shutdown,
    )

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(DP_RANKS),
                      RANK=str(rank), LOCAL_RANK="0")
    _require(init_from_env(backend="gloo") == (rank, DP_RANKS), "data-parallel rank joined")
    mesh = data_parallel_mesh()
    dev = mesh.device
    per_rank = DP_CHUNKS // DP_RANKS
    chunks = [dp_chunk(dev, i) for i in range(rank * per_rank, (rank + 1) * per_rank)]
    classification = ShardedEvaluator({
        "accuracy": MulticlassAccuracy(num_classes=HEADLINE_CLASSES, device=dev),
        "f1_macro": MulticlassF1Score(num_classes=HEADLINE_CLASSES, average="macro", device=dev),
    }, mesh=mesh)
    auroc = ShardedEvaluator(BinaryAUROC(compaction_threshold=DP_THRESHOLD, device=dev), mesh=mesh)
    # untimed warm-up on local metrics (no collective): a fresh process loads
    # each PyTorch kernel at its first call
    head = [c[: 1 << 16] for c in chunks[0]]
    MulticlassAccuracy(num_classes=HEADLINE_CLASSES, device=dev).update(head[0], head[1]).compute()
    MulticlassF1Score(num_classes=HEADLINE_CLASSES, average="macro", device=dev).update(
        head[0], head[1]).compute()
    BinaryAUROC(compaction_threshold=1 << 15, device=dev).update(head[2], head[3]).update(
        head[2], head[3]).compute()
    # the row count of every compaction this rank runs, so that the parent
    # holds the kernel against its plain version at these sizes
    fold_rows = []
    compact = stream_compact_module.compact_summary_rows

    def recording_compact(scores, *rest):
        fold_rows.append(int(scores.shape[0]))
        return compact(scores, *rest)

    stream_compact_module.compact_summary_rows = recording_compact
    torch.cuda.synchronize()
    dist.barrier()
    hist.launches = 0
    stream_compact.launches = 0
    wire = toolkit._allgather_stacked
    wire.rounds, wire.payload_bytes, wire.seconds = 0, 0, 0.0
    folds0 = fold_counts()
    t0 = time.perf_counter()
    for scores, labels, logits, binary in chunks:
        classification.update(scores, labels)
        auroc.update(logits, binary)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results = classification.compute()
    t2 = time.perf_counter()
    auroc_v = float(auroc.compute())
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    out = {
        "rank": rank,
        "seconds": t3 - t0,
        "update_seconds": t1 - t0,
        "classification_compute_seconds": t2 - t1,
        "auroc_compute_seconds": t3 - t2,
        "accuracy": float(results["accuracy"]),
        "f1_macro": float(results["f1_macro"]),
        "auroc": auroc_v,
        "hist_launches": hist.launches,
        "stream_compact_launches": stream_compact.launches,
        "fold_rows": fold_rows,
        "sync_rounds": wire.rounds,
        "sync_payload_bytes": wire.payload_bytes,
        "sync_seconds": wire.seconds,
        "cadence": cadence(folds0),
    }
    # the synced counts, for the exact check (two more small syncs)
    for name in ("accuracy", "f1_macro"):
        sd = toolkit.get_synced_state_dict(classification.metrics[name], recipient_rank="all")
        out[f"{name}_counts"] = {k: v.cpu().tolist() for k, v in sd.items()}
    shutdown()
    print("DP_RESULT " + json.dumps(out), flush=True)
    return 0


def dp_leg():
    """Spawn the ranks, wait for them (killing all at the time limit) and
    return each rank's result; any rank's failure fails the leg."""
    port = str(_free_port())
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", str(r), port],
                         cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(DP_RANKS)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(err[-6000:], file=sys.stderr)
            raise RuntimeError(f"check failed: data-parallel rank {r} exited {p.returncode}")
        lines = [ln for ln in out.splitlines() if ln.startswith("DP_RESULT ")]
        _require(len(lines) == 1, f"data-parallel rank {r} printed its result")
        results.append(json.loads(lines[0][len("DP_RESULT "):]))
    return results


def dp_reference(dev):
    """One process over all 8 chunks without the port's kernels: the class
    counts by ``torch.bincount``, the values from those counts, and the
    AUROC uncompacted (a sort, no compaction kernel)."""
    from torcheval_tpu_torch.metrics import BinaryAUROC
    from torcheval_tpu_torch.metrics.functional.classification.f1_score import _f1_score_compute

    c = HEADLINE_CLASSES
    correct, total = 0, 0
    tp, label, pred = (torch.zeros(c, dtype=torch.int64, device=dev) for _ in range(3))
    auroc = BinaryAUROC(device=dev)
    for i in range(DP_CHUNKS):
        scores, labels, logits, binary = dp_chunk(dev, i)
        p = scores.argmax(1)
        hit = p == labels
        correct += int(hit.sum())
        total += labels.numel()
        tp += torch.bincount(labels[hit], minlength=c)
        label += torch.bincount(labels, minlength=c)
        pred += torch.bincount(p, minlength=c)
        auroc.update(logits, binary)
        del scores, labels, logits, binary, p, hit
    counts = {
        "accuracy": {"num_correct": correct, "num_total": total},
        "f1_macro": {"num_tp": tp.tolist(), "num_label": label.tolist(), "num_prediction": pred.tolist()},
    }
    f1 = _f1_score_compute(tp.to(torch.int32), label.to(torch.int32), pred.to(torch.int32), "macro")
    return counts, correct / total, float(f1), float(auroc.compute())


def nccl_world_of_one(dev, gen):
    """A one-rank NCCL world through ``init_from_env``; the sharded class
    counts run one histogram launch and one NCCL all_reduce there."""
    import torch.distributed as dist

    from torcheval_tpu_torch.ops.hist import hist, hist_plain, sharded_class_counts
    from torcheval_tpu_torch.parallel import init_from_env, shutdown

    keys = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    try:
        _require(init_from_env() == (0, 1), "NCCL world of one joined")
        _require(dist.get_backend() == "nccl", f"backend {dist.get_backend()} is nccl")
        labels = torch.randint(-3, HEADLINE_CLASSES + 3, (HEADLINE_CHUNK,), generator=gen, device=dev)
        before = hist.launches
        counts = sharded_class_counts(labels, HEADLINE_CLASSES)
        torch.cuda.synchronize()
        launched = hist.launches - before
        _require(launched == 1, f"sharded class counts launched hist {launched} time(s)")
        _require(counts.device == dev and torch.equal(counts, hist_plain(labels, HEADLINE_CLASSES)),
                 "sharded class counts over NCCL equal the plain histogram")
    finally:
        shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return launched


# ------------------------------------------------------------------ phase 5
def kernel_rows(dev, gen, timer, launches, errs, fold):
    from torcheval_tpu_torch.ops.hist import hist, hist_plain
    from torcheval_tpu_torch.ops.stream_compact import (
        compact_summary_rows,
        compact_summary_rows_plain,
    )

    labels = torch.randint(0, MACRO_CLASSES, (MACRO_CHUNK,), generator=gen, device=dev)
    hist_bytes = labels.numel() * labels.element_size() + MACRO_CLASSES * 4
    rows = [{
        "name": "hist",
        "route": "cuda",
        "source": "torcheval_tpu_torch/csrc/hist.cu",
        "replaces": "torcheval_tpu/ops/pallas_hist.py:55",
        "launches": launches["hist"],
        "max_abs_err": errs["hist"],
        "ms": timer.ms(lambda: hist(labels, MACRO_CLASSES)),
        "plain_ms": timer.ms(lambda: hist_plain(labels, MACRO_CLASSES)),
        "bound_ms": hist_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": timer.ms(lambda: torch.bincount(labels, minlength=MACRO_CLASSES)),
        "shape": f"labels ({MACRO_CHUNK},) int64, C={MACRO_CLASSES}",
    }]
    # information: every label equal, every lane of every warp on one bin;
    # and one PyTorch reduction over the same labels, the time of a single
    # read of them under this timer
    equal = torch.full_like(labels, 7)
    rows[0]["at_every_label_equal"] = {
        "ms": timer.ms(lambda: hist(equal, MACRO_CLASSES)),
        "library_ms": timer.ms(lambda: torch.bincount(equal, minlength=MACRO_CLASSES)),
    }
    rows[0]["labels_sum_ms"] = timer.ms(lambda: labels.sum())
    # information: a short stream at a small and a large class count (the
    # headline's 5 classes, one tile of 20000 bins)
    for c in (HEADLINE_CLASSES, 20000):
        short = torch.randint(0, c, (1 << 20,), generator=gen, device=dev)
        rows[0][f"at_1048576_c{c}"] = {
            "ms": timer.ms(lambda: hist(short, c)),
            "library_ms": timer.ms(lambda: torch.bincount(short, minlength=c)),
        }
    s, tp, fp, keep = fold
    n = s.numel()
    stacked = torch.stack([s.view(torch.int32), tp, fp])
    # mask read once, three 4-byte columns read once and written once
    compact_bytes = n * (keep.element_size() + 3 * 4 + 3 * 4) + 4
    rows.append({
        "name": "stream_compact",
        "route": "cuda",
        "source": "torcheval_tpu_torch/csrc/stream_compact.cu",
        "replaces": "torcheval_tpu/ops/stream_compact.py:103",
        "launches": launches["stream_compact"],
        "max_abs_err": errs["stream_compact"],
        "ms": timer.ms(lambda: compact_summary_rows(s, tp, fp, keep)),
        "plain_ms": timer.ms(lambda: compact_summary_rows_plain(s, tp, fp, keep)),
        "bound_ms": compact_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": timer.ms(lambda: stacked[:, keep]),
        "shape": f"first AUROC fold: {n} rows, {int(keep.sum())} kept",
    })
    rows.append(topk_row(dev, gen, timer, launches["topk"], errs["topk"]))
    return rows


def segment_sum_row(dev, timer, launches, err, leg_rows, leg_scores, leg_targets, window):
    """The kernel at the sliced leg's two launches a batch, on one of its
    batches, into 1,000,000 cohorts by the batch's interned rows: the
    accuracy member's (N, 2) int32 deltas (num_correct, num_total), and the
    Mean member's (N, 2) float32 deltas (weighted_sum, weights: the scores
    and ones, stacked as the fold stacks them); and the same two at the
    leg's window, its 16 batches in one launch each (``window``: their rows,
    scores and targets). Information: the int32 deltas with every row 0 (one
    cohort takes the batch) and with uniform rows."""
    from torcheval_tpu_torch.ops.scatter import segment_sum, segment_sum_plain

    s = SLICED_COHORTS

    def times(vals, rows=leg_rows):
        n, d = vals.shape
        size = vals.element_size()

        def library():
            return torch.zeros((s, d), dtype=vals.dtype, device=dev).index_add_(0, rows, vals)

        return {
            "ms": timer.ms(lambda: segment_sum(vals, rows, s)),
            "plain_ms": timer.ms(lambda: segment_sum_plain(vals, rows, s)),
            "bound_ms": (n * d * size + n * rows.element_size() + s * d * size)
            / HBM_BYTES_PER_S * 1e3,
            "library_ms": timer.ms(library),
        }

    correct = ((leg_scores >= 0.5).to(torch.float32) == leg_targets).to(torch.int32)
    deltas = torch.stack([correct, torch.ones_like(correct)], dim=-1)
    row = {
        "name": "segment_sum",
        "route": "cuda",
        "source": "torcheval_tpu_torch/csrc/scatter.cu",
        "replaces": "torcheval_tpu/ops/scatter.py:95",
        "launches": launches,
        "max_abs_err": err,
        **times(deltas),
        "bound_by": "bytes",
        "shape": f"({SLICED_ROWS}, 2) int32 deltas into {s} cohorts, power-law rows of the sliced leg",
    }
    row["at_f32_d2"] = times(torch.stack([leg_scores, torch.ones_like(leg_scores)], dim=-1))
    w_rows, w_scores, w_targets = window
    w_correct = ((w_scores >= 0.5).to(torch.float32) == w_targets).to(torch.int32)
    row["at_window_i32_d2"] = times(torch.stack([w_correct, torch.ones_like(w_correct)], dim=-1), w_rows)
    del w_correct
    row["at_window_f32_d2"] = times(torch.stack([w_scores, torch.ones_like(w_scores)], dim=-1), w_rows)
    row["at_i32_d2_every_row_0"] = times(deltas, torch.zeros_like(leg_rows))
    uniform = torch.randint(0, s, leg_rows.shape, device=dev, dtype=leg_rows.dtype,
                            generator=torch.Generator(device=dev).manual_seed(SEED))
    row["at_i32_d2_uniform_rows"] = times(deltas, uniform)
    # information: the wrapper's zeroing of the (S, 2) output alone
    row["zeroing_ms"] = timer.ms(lambda: torch.zeros((s, 2), dtype=torch.int32, device=dev))
    return row


def topk_row(dev, gen, timer, launches, err):
    from torcheval_tpu_torch.ops.topk import topk_kernel, topk_kernel_plain

    def times(n, l, k):
        x = torch.rand((n, l), generator=gen, device=dev)
        # each score read once, each value (4 B) and int64 index (8 B) written once
        return {
            "ms": timer.ms(lambda: topk_kernel(x, k)),
            "plain_ms": timer.ms(lambda: topk_kernel_plain(x, k)),
            "bound_ms": (n * l * 4 + n * k * 12) / HBM_BYTES_PER_S * 1e3,
            "library_ms": timer.ms(lambda: torch.topk(x, k)),
        }

    row = {
        "name": "topk",
        "route": "cuda",
        "source": "torcheval_tpu_torch/csrc/topk.cu",
        "replaces": "torcheval_tpu/ops/topk.py:206",
        "launches": launches,
        "max_abs_err": err,
        **times(TOPK_ROWS, TOPK_LABELS, TOPK_K),
        "bound_by": "bytes",
        "shape": f"({TOPK_ROWS}, {TOPK_LABELS}) float32, k={TOPK_K}",
    }
    row["at_64x1000000_k100"] = times(RETRIEVAL_ROWS, RETRIEVAL_LABELS, 100)
    row["at_64x1000000_k10"] = times(RETRIEVAL_ROWS, RETRIEVAL_LABELS, 10)
    # information: every value tied, so the selection runs through the index
    # digits (the kernel's worst case in reads of the row)
    equal = torch.full((RETRIEVAL_ROWS, RETRIEVAL_LABELS), 0.5, device=dev)
    row["at_64x1000000_k100_all_equal"] = {
        "ms": timer.ms(lambda: topk_kernel(equal, 100)),
        "library_ms": timer.ms(lambda: torch.topk(equal, 100)),
    }
    return row


def first_fold_inputs(chunks):
    """The (s, tp, fp, keep) that the first compaction hands the kernel."""
    from torcheval_tpu_torch.ops.summary import group_deltas_sorted, sort_descending

    scores = torch.cat([c[2] for c in chunks[:THRESHOLD // HEADLINE_CHUNK]])
    t = torch.cat([c[3] for c in chunks[:THRESHOLD // HEADLINE_CHUNK]]).to(torch.int32)
    s, (tp_c, fp_c) = sort_descending(scores, t, 1 - t)
    delta_tp, delta_fp, keep, _ = group_deltas_sorted(s, tp_c, fp_c)
    return scores, t, (s, delta_tp, delta_fp, keep)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs one CUDA device.",
              file=sys.stderr)
        return 1
    from torcheval_tpu_torch import _build
    from torcheval_tpu_torch.ops.hist import hist
    from torcheval_tpu_torch.ops.scatter import segment_sum
    from torcheval_tpu_torch.ops.stream_compact import stream_compact
    from torcheval_tpu_torch.ops.topk import topk_kernel

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    _, build_log = _build.build_report()
    print(build_log, file=sys.stderr)
    print(f"phase 1 device: {name}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
          f"kernel build {build_s:.2f} s")
    print(smi)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    chunks = headline_data(dev, gen)
    fold_scores, fold_t, fold = first_fold_inputs(chunks)

    print("phase 2 kernels against their plain versions")
    errs = {"hist": check_hist(dev, gen), "stream_compact": check_compaction(dev, gen),
            "topk": check_topk(dev, gen), "segment_sum": check_segment_sum(dev)}
    check_compact_counts(dev, gen, fold_scores, fold_t)
    del fold_scores, fold_t
    torch.cuda.synchronize()

    print("phase 3 headline leg")
    hist.launches = 0
    stream_compact.launches = 0
    folds0 = fold_counts()
    acc, acc_v, auroc_v, seconds, host_seconds, peak = headline_leg(dev, chunks)
    headline_launches = {"hist": hist.launches, "stream_compact": stream_compact.launches}
    headline_cadence = cadence(folds0)
    total = HEADLINE_CHUNKS * HEADLINE_CHUNK
    _require(stream_compact.launches >= 2, f"stream_compact launches {stream_compact.launches} >= 2")
    correct, auroc_ref = headline_reference(dev, chunks)
    _require(int(acc.num_correct) == correct and int(acc.num_total) == total, "headline accuracy counts")
    _require(_close(acc_v, correct / total), "headline accuracy value")
    _require(np.isfinite(auroc_v) and _close(auroc_v, auroc_ref),
             f"compacted AUROC {auroc_v} vs uncompacted {auroc_ref}")
    print(f"  {total} predictions in {seconds:.4f} s (CUDA events): {total / seconds:.1f} preds/s "
          f"({host_seconds:.4f} s on the host clock); "
          f"peak memory {peak / 2**30:.2f} GiB (incl. {HEADLINE_CHUNKS} resident input chunks)")
    print(f"  accuracy {acc_v:.8f} (direct count {correct / total:.8f}); "
          f"AUROC {auroc_v:.8f} (uncompacted {auroc_ref:.8f}); launches {headline_launches}")
    print(f"  fold cadence: {cadence_text(headline_cadence)}")
    small_reference_check(dev)
    del chunks, acc
    torch.cuda.empty_cache()

    print("phase 4 macro leg")
    hist.launches = 0
    stream_compact.launches = 0
    folds0 = fold_counts()
    macro_v, update_ms = macro_leg(dev, gen)
    macro_launches = {"hist": hist.launches, "stream_compact": stream_compact.launches}
    macro_cadence = cadence(folds0)
    _require(hist.launches > 0, "hist launched on the macro leg")
    macro_total = MACRO_CHUNKS * MACRO_CHUNK
    print(f"  macro accuracy {macro_v:.8f} over {macro_total} rows (counts equal the plain "
          f"histogram); update time {update_ms:.3f} ms: {macro_total / update_ms * 1e3:.1f} "
          f"preds/s; launches {macro_launches}")
    print(f"  fold cadence: {cadence_text(macro_cadence)}")

    print("phase 4 small-batch leg (BASELINE config 1, with distinct batches)")
    batches = small_batch_data(dev, gen)
    small_batch_leg(dev, batches)  # warm-up: the first use of each PyTorch kernel
    small_batch_standalone(dev, batches)
    hist.launches = 0
    stream_compact.launches = 0
    folds0 = fold_counts()
    col, out, small_s, small_host = small_batch_leg(dev, batches)
    small_launches = {"hist": hist.launches, "stream_compact": stream_compact.launches}
    small_cadence = cadence(folds0)
    _require(hist.launches > 0, "hist launched on the small-batch leg")
    small_acc, small_f1 = check_small_batch(col, out, batches)
    folds0 = fold_counts()
    alone_v, alone_s = small_batch_standalone(dev, batches)
    alone_cadence = cadence(folds0)
    _require(_close(alone_v, small_acc), f"standalone accuracy {alone_v} vs {small_acc}")
    n_rows = SMALL_BATCHES * SMALL_ROWS
    print(f"  accuracy {small_acc:.8f} and macro F1 {small_f1:.8f} over {n_rows} rows "
          f"(counts equal torch.bincount's) in {small_s:.6f} s (CUDA events; {small_host:.6f} s "
          f"on the host clock): {n_rows / small_s:.1f} rows/s; launches {small_launches}")
    print(f"  fold cadence: {cadence_text(small_cadence)}")
    print(f"  standalone MulticlassAccuracy (config 1 itself, information): {n_rows / alone_s:.1f} "
          f"rows/s ({alone_s:.6f} s); fold cadence: {cadence_text(alone_cadence)}")
    del batches, col, out

    print("phase 4 top-k leg (BASELINE config 4)")
    batches = topk_leg_data(dev, gen)
    topk_leg(dev, batches)  # warm-up: the first use of each PyTorch kernel
    topk_kernel.launches = 0
    folds0 = fold_counts()
    _, topk_v, topk_s, topk_peak = topk_leg(dev, batches)
    topk_launches = topk_kernel.launches
    topk_cadence = cadence(folds0)
    _require(topk_launches > 0, "topk launched on the top-k leg")
    n_rows = TOPK_BATCHES * TOPK_ROWS
    print(f"  contain accuracy {topk_v:.8f} over {n_rows} rows of {TOPK_LABELS} labels in "
          f"{topk_s:.4f} s (CUDA events): {n_rows / topk_s:.1f} rows/s; topk launches "
          f"{topk_launches}; peak memory {topk_peak / 2**30:.2f} GiB (incl. {TOPK_BATCHES} "
          f"resident batches)")
    print(f"  fold cadence: {cadence_text(topk_cadence)}")
    check_topk_leg(dev, batches)
    del batches
    torch.cuda.empty_cache()

    print("phase 4 retrieval leg (BASELINE config 6)")
    batches = retrieval_leg_data(dev, gen)
    retrieval_launches = 0
    for k in RETRIEVAL_KS:
        retrieval_leg(dev, batches, k)  # warm-up
        topk_kernel.launches = 0
        folds0 = fold_counts()
        ndcg, value, seconds = retrieval_leg(dev, batches, k)
        launched = topk_kernel.launches
        ndcg_cadence = cadence(folds0)
        retrieval_launches += launched
        _require(launched > 0 and np.isfinite(value), f"NDCG@{k} launched the kernel, finite")
        plain, plain_value, _ = retrieval_leg(dev, batches, k, topk_method="dense")
        _require(int(ndcg.num_valid) == int(plain.num_valid) and _close(value, plain_value),
                 f"NDCG@{k} {value} vs dense route {plain_value}")
        n_rows = RETRIEVAL_BATCHES * RETRIEVAL_ROWS
        print(f"  NDCG@{k} {value:.8f} (dense route {plain_value:.8f}) over {n_rows} rows of "
              f"{RETRIEVAL_LABELS} labels in {seconds:.4f} s (CUDA events): {n_rows / seconds:.1f} "
              f"rows/s; topk launches {launched}")
        print(f"  fold cadence: {cadence_text(ndcg_cadence)}")
    del batches
    torch.cuda.empty_cache()

    print("phase 4 sliced leg (bench.py config11_sliced, without its AUROC sketch member)")
    data = sliced_leg_data(dev, gen)
    n_rows = SLICED_BATCHES * SLICED_ROWS
    sliced_epoch(dev, data, *sliced_setup(dev, data))  # warm-up: first use of each kernel
    acc, agg = sliced_setup(dev, data)
    segment_sum.launches = 0
    folds0 = fold_counts()
    results, sliced_s, sliced_wall, sliced_peak = sliced_epoch(dev, data, acc, agg)
    sliced_launches = segment_sum.launches
    sliced_cadence = cadence(folds0)
    _require(sliced_launches > 0, "segment_sum launched on the sliced leg")
    worst_mean = check_sliced_leg(data, acc, agg, results)
    intern_s = interning_seconds(acc.slice_table, data)
    plain_s = unsliced_leg(dev, data)
    print(f"  {n_rows} rows into {SLICED_COHORTS} cohorts in {sliced_s:.4f} s (CUDA events; "
          f"{sliced_wall:.4f} s on the host clock): {n_rows / sliced_s:.1f} rows/s")
    print(f"  host interning {intern_s:.4f} s per batch per collection (two collections intern "
          f"each batch); peak memory {sliced_peak / 2**30:.2f} GiB (incl. all "
          f"{SLICED_BATCHES + 1} resident batches); segment_sum launches {sliced_launches}")
    print(f"  fold cadence: {cadence_text(sliced_cadence)}; segment_sum launches per epoch "
          f"{sliced_launches}")
    print(f"  per-cohort num_correct/num_total and max equal numpy exactly; means within "
          f"{worst_mean:.3e} of float64; slice ids in first-seen order")
    print(f"  unsliced MetricCollections on identical rows: {plain_s:.4f} s "
          f"({n_rows / plain_s:.1f} rows/s); config11_sliced_ratio {plain_s / sliced_s:.4f}")
    leg_rows = torch.from_numpy(acc.slice_table.lookup_rows(_sliced_batch(data, 1)[0])).to(dev)
    _, leg_scores, leg_targets = _sliced_batch(data, 1)
    window = slice(SLICED_ROWS, (SLICED_BATCHES + 1) * SLICED_ROWS)
    window_inputs = (torch.from_numpy(acc.slice_table.lookup_rows(data[0][window])).to(dev),
                     data[1][window], data[2][window])
    del acc, agg, results
    torch.cuda.empty_cache()

    print(f"phase 4 data-parallel leg ({DP_RANKS} ranks on one card over gloo, "
          f"{DP_CHUNKS} chunks of {HEADLINE_CHUNK})")
    ranks = dp_leg()
    counts, acc_ref, f1_ref, auroc_ref = dp_reference(dev)
    dp_total = DP_CHUNKS * HEADLINE_CHUNK
    for res in ranks:
        r = res["rank"]
        _require(res["accuracy_counts"] == counts["accuracy"], f"rank {r} synced accuracy counts")
        _require(res["f1_macro_counts"] == counts["f1_macro"], f"rank {r} synced F1 counts")
        _require(_close(res["accuracy"], acc_ref) and _close(res["f1_macro"], f1_ref),
                 f"rank {r} accuracy {res['accuracy']} and F1 {res['f1_macro']} vs the plain "
                 f"counts' {acc_ref} and {f1_ref}")
        _require(np.isfinite(res["auroc"]) and _close(res["auroc"], auroc_ref),
                 f"rank {r} synced AUROC {res['auroc']} vs uncompacted {auroc_ref}")
        _require(res["sync_rounds"] == 4, f"rank {r}: two collections, two rounds each")
        _require(res["hist_launches"] > 0 and res["stream_compact_launches"] >= 2,
                 f"rank {r} launched hist and stream_compact")
        print(f"  rank {r}: {dp_total} predictions over {DP_RANKS} ranks in {res['seconds']:.4f} s "
              f"from its first update() to the synced compute(): {dp_total / res['seconds']:.1f} "
              f"preds/s; sync {res['sync_seconds']:.4f} s in {res['sync_rounds']} rounds, "
              f"{res['sync_payload_bytes']} payload bytes sent; launches hist "
              f"{res['hist_launches']}, stream_compact {res['stream_compact_launches']}")
        print(f"  rank {r}: updates {res['update_seconds']:.4f} s, accuracy+F1 compute "
              f"{res['classification_compute_seconds']:.4f} s, AUROC compute (its pre-sync "
              f"fold, the sync and the sort of the synced summaries) "
              f"{res['auroc_compute_seconds']:.4f} s")
        print(f"  rank {r}: fold cadence: {cadence_text(res['cadence'])}")
    slowest = max(res["seconds"] for res in ranks)
    print(f"  synced on every rank: accuracy {ranks[0]['accuracy']:.8f}, f1_macro "
          f"{ranks[0]['f1_macro']:.8f} (counts equal torch.bincount's over all chunks: "
          f"{acc_ref:.8f}, {f1_ref:.8f}), AUROC {ranks[0]['auroc']:.8f} (uncompacted "
          f"{auroc_ref:.8f}); {dp_total / slowest:.1f} preds/s by the slowest rank")
    fold_sizes = sorted({n for res in ranks for n in res["fold_rows"]})
    print(f"  compaction kernel at the leg's fold sizes {fold_sizes}:")
    errs["stream_compact"] = max(errs["stream_compact"], check_compaction(dev, gen, fold_sizes))
    nccl_launches = nccl_world_of_one(dev, gen)
    print(f"  NCCL world of one through init_from_env: sharded class counts equal the plain "
          f"histogram ({nccl_launches} hist launch, one NCCL all_reduce)")
    dp_launches = {
        "hist": sum(res["hist_launches"] for res in ranks) + nccl_launches,
        "stream_compact": sum(res["stream_compact_launches"] for res in ranks),
    }

    print("phase 5 kernel timings at the main path's shapes")
    launches = {k: headline_launches[k] + macro_launches[k] + small_launches[k] + dp_launches[k]
                for k in headline_launches}
    launches["topk"] = topk_launches + retrieval_launches
    timer = Timer(dev)
    rows = kernel_rows(dev, gen, timer, launches, errs, fold)
    rows.append(segment_sum_row(dev, timer, sliced_launches, errs["segment_sum"],
                                leg_rows, leg_scores, leg_targets, window_inputs))
    del window_inputs
    torch.cuda.synchronize()
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f}) at {r['shape']}")
    for k in (100, 10):
        big = rows[2][f"at_64x1000000_k{k}"]
        print(f"  topk: {big['ms']:.4f} ms (plain {big['plain_ms']:.4f}, library "
              f"{big['library_ms']:.4f}, bound {big['bound_ms']:.4f}) at (64, 1000000) float32, k={k}")
    equal = rows[2]["at_64x1000000_k100_all_equal"]
    print(f"  topk: {equal['ms']:.4f} ms (library {equal['library_ms']:.4f}) at (64, 1000000) "
          f"float32 all equal, k=100 (information)")
    equal = rows[0]["at_every_label_equal"]
    print(f"  hist: {equal['ms']:.4f} ms (library {equal['library_ms']:.4f}) at labels "
          f"({MACRO_CHUNK},) int64 all equal, C={MACRO_CLASSES} (information); one "
          f"labels.sum() over the leg's labels {rows[0]['labels_sum_ms']:.4f} ms")
    for c in (HEADLINE_CLASSES, 20000):
        t = rows[0][f"at_1048576_c{c}"]
        print(f"  hist: {t['ms']:.4f} ms (library {t['library_ms']:.4f}) at labels (1048576,) "
              f"int64, C={c} (information)")
    print(f"  segment_sum: the wrapper's zeroing of the ({SLICED_COHORTS}, 2) output alone "
          f"{rows[3]['zeroing_ms']:.4f} ms (information)")
    n_window = SLICED_BATCHES * SLICED_ROWS
    for key, what in (("at_window_i32_d2", f"int32 deltas, the sliced leg's window of {n_window} rows"),
                      ("at_window_f32_d2", f"float32 deltas, the sliced leg's window of {n_window} rows")):
        t = rows[3][key]
        print(f"  segment_sum: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library "
              f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f}) at ({n_window}, 2) {what} "
              f"into {SLICED_COHORTS} cohorts")
    for key, what in (("at_f32_d2", "float32 deltas, power-law rows of the sliced leg"),
                      ("at_i32_d2_every_row_0", "int32 deltas, every row 0 (information)"),
                      ("at_i32_d2_uniform_rows", "int32 deltas, uniform rows (information)")):
        t = rows[3][key]
        print(f"  segment_sum: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library "
              f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f}) at ({SLICED_ROWS}, 2) {what} "
              f"into {SLICED_COHORTS} cohorts")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--dp-rank":
        sys.exit(dp_worker(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
