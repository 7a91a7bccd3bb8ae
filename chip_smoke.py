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
   1,638,400 labels into 10 bins; and at the shapes of the config-3 and
   curve legs: the histogram over 1,300,000 joint keys into 10^6 bins and
   over 10^7 binned keys into 202,000 bins, the segment sum over the binned
   curve's stacked window (5 * 10^7 keys into 1,010,000 segments), and the
   per-class compaction bit for bit against the batched two-sort at the
   curve leg's two fold widths; the segment sum bit for bit at the sketch
   folds' shapes: (2^24,) int32 ones into 10^6 x 33 segments (the sliced
   window's 4-bit sketch), (2^24, 2) int32 lanes into 2^16 buckets (a binary
   ``approx=True`` fold of a headline chunk), (2^26,) int32 ones into 4 x
   2^16 buckets (``Quantile``'s stacked value fold of four headline chunks)
   and (10^7, 2) into 1000 x 4096 (a multiclass fold of an ImageNet-val
   batch); ``bucket_index`` on the card against the CPU over +-0,
   +-subnormals, +-tiny, +-inf, NaN and bfloat16 and float16 inputs; and the
   sliced sketch member at 4 and 10 bits over scores spread across every
   bucket (sign times 2^e, e uniform over the normal range, targets
   correlated with the score), its counts exactly against numpy, its AUROC
   within rtol 1e-5 of the float64 trapezoid and, in every cohort, within
   the sketch's error bound (itself well below the distance to 0.5) of the
   exact Mann-Whitney value; and the shapes one rank of the sharded leg
   gives the kernels: the top-k at a (64, 500,000) label tile (k = 100 and
   10) and a (32, 10^6) row block, and the segment sum at the slice tile,
   (2^24, 2) int32 with half the rows out of a 500,000-cohort tile, and at
   the tile's sketch fold, (2^24,) ones into 500,000 x 33, half at -1;
3. headline leg: ``MulticlassAccuracy(num_classes=5)`` and
   ``BinaryAUROC(compaction_threshold=6 * 2**24)`` over 16 chunks of 2^24
   predictions, checked against an uncompacted ``BinaryAUROC`` and a direct
   count, plus a small stream checked against float64 numpy references;
   the obs registry (``torcheval_tpu_torch.obs``) is on from phase 2 to the
   end of phase 4, every launch, fold and round being read from it, and is
   reset just before the headline leg; then the obs phase, on phase 3's
   chunks: (a) the headline and the small-batch leg (from their own seed)
   3 times with obs off and 3 times on, alternating, values equal bit for
   bit, the median rates and their ratio printed; (b) one enabled headline
   run: 16 ``metric.update`` spans and one ``metric.compute`` span a metric,
   the launches against the C entry points' calls and phase 3's counts, at
   most 2 first sights an entry and no storm warning, the compaction's
   ``obs.cost.bytes_accessed`` equal to phase 5's byte count (the
   histogram's is checked after the macro leg), a Chrome trace that parses
   with nested spans, Prometheus sample lines in the exposition format;
   (c) one enabled run under ``torch.profiler``: every histogram and
   compaction kernel launched inside a ``metric.*``, ``collection.*`` or
   ``jit/<entry>`` range, device ms by range printed; (d) in the
   data-parallel leg, each rank's ``obs.sync_snapshot(timeout_s=30)`` (one
   round, merged counters equal to the sum of the ranks', rank-labelled
   gauges) and rank 0's ``MetricsServer`` (``GET /metrics`` equal to
   ``prometheus_text()``, ``GET /health``);
   approximate headline leg (phase 4, on phase 3's data):
   ``BinaryAUROC(approx=True)``, ``BinaryAUPRC(approx=True)`` and
   ``Quantile(q=(0.5, 0.9, 0.99))`` over the same binary logits, the
   sketch's counts summing to 2^28, AUROC and AUPRC within the sketch's own
   error bounds of phase 3's exact AUROC and of the exact average precision,
   the quantiles within 2^-7 of the order statistics of a sort on the card;
4. macro leg: ``MulticlassAccuracy(average="macro", num_classes=1000)`` over
   8 chunks of 2^22 rows, checked against the plain histogram;
   small-batch leg (BASELINE config 1, ``bench.py:498-553``, with distinct
   batches): a ``MetricCollection`` of ``MulticlassAccuracy(num_classes=5)``
   and macro ``MulticlassF1Score(num_classes=5)`` over 200 batches of
   (8192, 5) scores, which fold in one window; the counts checked exactly
   against ``torch.bincount``'s over all batches, the values within rtol
   1e-5; and, as information, a standalone ``MulticlassAccuracy`` over the
   same stream (config 1 itself);
   config-3 leg (BASELINE config 3, ``bench.py:639-733``, with distinct
   batches): ``MulticlassConfusionMatrix(1000)`` and macro
   ``MulticlassF1Score`` over 13 batches of 100,000 int32 predictions, in
   one ``MetricCollection`` and standalone; the matrix checked exactly
   against ``torch.bincount``, F1 (and, as information, macro precision and
   recall) within rtol 1e-5 of float64 values from it;
   recommendation-eval leg (about one MLPerf DLRM evaluation pass over
   Criteo Terabyte's held-out day a task): ``BinaryNormalizedEntropy(
   num_tasks=3, from_logits=True)``, ``ClickThroughRate(num_tasks=3)``,
   ``WeightedCalibration(num_tasks=3)`` and their windowed forms (window 8)
   over 16 batches of (3, 2^22) logits, 3% clicks and weights, in three
   ``MetricCollection``s (one per update signature); counts exactly, every
   value within rtol 1e-5 of float64 sums on the card (lifetime and the
   last 8 batches), ``Throughput`` (the CUDA-event time) equal to rows over
   elapsed time; prints preds/s, peak memory and the fold cadence; and
   ``R2Score`` in its three ``multioutput`` modes over 4 batches of (2^22,
   8), within rtol 1e-5 of float64;
   ImageNet-val curve leg: ``MulticlassAUROC`` and ``MulticlassAUPRC``
   (``compaction_threshold=20_000``) and
   ``MulticlassBinnedPrecisionRecallCurve(1000, threshold=100)`` over 5
   batches of (10,000, 1000) softmax scores, per class within rtol 1e-5 of
   float64 numpy, the binned counts exactly against numpy's, and
   ``multiclass_precision_recall_curve`` on the first batch against the
   CPU; and its approximate twin, ``MulticlassAUROC(1000, approx=True)`` and
   ``MulticlassAUPRC(1000, approx=True)`` (2^12 buckets), each class within
   its error bound of the exact value;
   top-k leg: ``TopKMultilabelAccuracy(k=5, criteria="contain")`` over 4
   batches of (8192, 10000) scores, every criterion's counts checked
   against the plain top-k and the first 64 rows against a float64 numpy
   reference;
   retrieval leg: ``NDCG(k=10)`` and ``NDCG(k=100)`` over 4 batches of
   (64, 1,000,000) scores, checked against the dense (sorting) route;
   sliced leg: ``SlicedMetricCollection`` over 1,000,000 cohorts with
   power-law traffic, one registration batch and 16 batches of 1,048,576
   rows, ``{"acc": BinaryAccuracy(), "auroc": BinaryAUROC(approx=1024)}``
   with ``curve_bucket_bits=4`` (bench.py's ``config11_sliced`` whole) and
   ``{"mean": Mean(), "max": Max()}``, checked per cohort against numpy
   (counts, sketch counts and maxima exactly, means and the sketch's AUROC
   within rtol 1e-5, and 64 cohorts' AUROC within the sketch's error bound
   of the exact Mann-Whitney value);
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
   sharded leg: two ranks on the card over gloo (``chip_smoke.py
   --shard-rank R PORT DIR``), each with two 1-D ``DeviceMesh``es over the
   pair: ``NDCG(k=10)`` and ``NDCG(k=100)`` with ``label_mesh=`` over the
   retrieval leg's 4 batches, each rank holding its (64, 500,000) label
   tiles, the merged top-k indices of every batch equal to the one-process
   top-k's and the values within rtol 1e-5 of the retrieval leg's; the
   row-sharded top-k over each rank's 32 rows of those batches; bench
   ``config11_sliced`` with its ``Mean``/``Max`` pair through
   ``SlicedMetricCollection(mesh=, mesh_axis=)``, each rank holding
   500,000 cohorts, every cohort checked against numpy as in the sliced
   leg and its values equal to the sliced leg's (means within rtol 1e-5);
   and the sharded segment sum over each rank's half of the sliced window
   (one launch and one all_reduce), equal to the plain sum of the whole
   window; each rank prints its seconds, collective bytes and launches;
   distributed-curves leg: two ranks on the card over gloo (``chip_smoke.py
   --dist-rank R PORT DIR``), each computing through a ``ShardedEvaluator``
   of the two: (a) ``BinaryAUROC`` and ``BinaryAUPRC`` over its 4 of the
   data-parallel leg's 8 chunks (a raw cache of 2^26 rows a rank), equal
   within rtol 1e-5 to the one-process uncompacted AUROC and to a
   one-process ``BinaryAUPRC``; (b) per-class ``MulticlassAUROC`` and
   ``MulticlassAUPRC`` (1000 classes) over the ImageNet-val leg's shapes
   from a seed of their own, 3 and 2 of the 5 batches a rank, every class
   within rtol 1e-5 of one process; (c) ``BinaryAUROC(approx=True)`` over
   (a)'s chunks, its global sketch counts equal to a one-process approximate
   metric's and its value equal; (d) a batch with 80% of its scores tied
   (at a bucket capacity factor of 1: at two ranks the factor 4 holds every
   row) and a batch with NaN scores, on which both ranks take the gather
   route and equal one process. (a) and (b) run through the bucket exchange
   (``ops/dist_curves.py``) with no gather round, the histogram and the
   segment sum launched for their splitters; each rank prints its compute
   seconds on the distributed route and on the gather route (the toolkit's
   sync of clones), the collectives and bytes of each, the splitter
   all-reduce's seconds, the launches and peak memory; (e) (a) and (b) once
   more with ``TORCHEVAL_TPU_SYNC_QUANTIZE=bf16`` and once with ``int8``
   (the quantized routes: a bf16 or int8 splitter histogram beside a
   12-byte exact all-reduce, 5- and 6-byte exchange rows), each value within
   rtol 1e-5 of the raw route's, the routes, collective counts, launches
   and exchange bytes (5/8 and 6/8 of the raw rows) checked; a small case
   of quantized scores (AUROC bit-identical to raw, AUPRC within rtol
   1e-5), the NaN fallback under int8 and the sketch all-reduce under the
   int8 knob (exact); each rank prints the splitter round's bytes and
   seconds. Then the quantized sync: ``sync_and_compute_collection`` over
   the two ranks of config 3's ``MulticlassConfusionMatrix(1000)`` (the
   narrow lane), a ``BinaryAUROC(approx=True)`` sketch (the bucket lane) and
   a ``WeightedCalibration(num_tasks=256)`` (the q8 lane), with
   ``quantize=False`` and ``True``: the confusion matrix equal to
   ``torch.bincount``'s and the sketch AUROC equal in both, the calibration
   within ``max|block| / 254`` a rank, two rounds each, the rounds' payload
   bytes and seconds printed;
   resilience phase (``torcheval_tpu_torch.resilience``; checkpoints
   under a ``tempfile.mkdtemp()``
   directory, its disk usage printed first, removed at the end): (a) right
   after phase 3, on its chunks: ``MulticlassAccuracy(num_classes=5)`` and
   ``BinaryAUROC(compaction_threshold=6 * 2**24)`` saved after chunks 4 and
   8 (``keep_last=2``), a fresh pair restored from the chunk-8 generation
   (every leaf equal to the saved one as bytes) and fed chunks 9-16, both
   values equal to phase 3's bit for bit; (d) one payload byte of the
   chunk-8 generation flipped by the chaos hook (``ckpt_corrupt``),
   ``restore_latest_valid`` quarantining it and restoring the chunk-4
   generation (every leaf equal as bytes to the pair's state at chunk 4,
   one fallback counted); (b) right after the sliced leg: its two
   collections saved after batch 8, restored into fresh collections of
   the default capacity and fed batches 9-16, the counts, sketch planes
   and maxima equal to the uninterrupted leg's and the means within rtol
   1e-5; (c) right after the data-parallel leg, the kill drill
   (``chip_smoke.py --drill-rank R PORT DIR fault|restart``): two ranks
   feed 2 of their 4 chunks, save, sync once (rounds 1-2) and feed the
   rest; rank 1, armed by ``TORCHEVAL_TPU_CHAOS*``, dies with exit 43
   entering round 3 and rank 0's second sync (``timeout_s=30``,
   ``on_failure="local"``) returns its local values with one failure
   counted; both checkpoints restore on the card to the leaves saved, and
   two fresh ranks restore them, feed their chunks 3-4 and pass the
   data-parallel leg's gate. Each part prints its checkpoint bytes, save
   and restore seconds (the ``resilience.checkpoint`` spans), GB/s and
   kernel launches;
5. with obs off, one JSON line per the kernels: launches on the main path
   (phases 3 and 4, the data-parallel ranks' included; each kernel's
   ``jit.calls{entry=}``), time per launch, the plain
   version's and a library call's time, and the least time the card could
   take (its bound); the segment sum also at the sliced leg's window and
   the binned curve's; ``hist_c2``, the histogram at config 3's 10^6 bins
   (with the segment sum's time on the same keys), and
   ``stream_compact_rows``, the compaction over the curve leg's flattened
   per-class fold; the segment sum at the four sketch-fold shapes
   (``segment_sum_sketch_*``), with the sketch launches counted by leg; and
   the sharded leg's shapes (``topk_label_tile``, ``topk_row_block``,
   ``segment_sum_slice_tile``, ``segment_sum_sketch_slice_tile``,
   ``sharded_segment_sum``); and the distributed-curves leg's splitters
   (``hist_splitter``: 2^26 int32 bins into 2^16, beside ``torch.bincount``;
   ``segment_sum_splitter``: 3 x 10^7 int32 ones by ``c * 2^16 + bin`` into
   1000 x 2^16 rows, beside ``index_add_``), each first held bit-equal to
   its plain version.

Every leg prints its fold cadence: the window steps and the solo folds of
``metrics/deferred.py`` that it ran, and the batches each folded.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

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
# traffic, accuracy and a 4-bit AUROC sketch a cohort
SLICED_COHORTS, SLICED_ROWS, SLICED_BATCHES = 1_000_000, 1 << 20, 16
SLICED_ZIPF = 1.3
SLICED_BITS = 4
SLICED_PLANES = 2 * (1 << SLICED_BITS) + 1
SLICED_SAMPLE_COHORTS = 64
# the sketches' bucket counts: the binary and multiclass defaults
SKETCH_BITS, MC_SKETCH_BITS = 16, 12
QUANTILES = (0.5, 0.9, 0.99)
# Quantile's deferred batches of headline logits fold stacked: the 256 MiB
# byte valve holds four 64 MiB batches, so one launch folds (4, 2^24) values
QUANTILE_STACK = 4
# the data-parallel leg: the headline's data, 8 chunks over 2 ranks
DP_RANKS, DP_CHUNKS = 2, 8
DP_THRESHOLD = 3 * HEADLINE_CHUNK
DP_TIMEOUT_S = 600
# the distributed-curves leg: two ranks, the data-parallel leg's chunks and
# the ImageNet-val leg's shapes (its 5 batches, 3 and 2 a rank)
DIST_RANKS = 2
DIST_TIMEOUT_S = 900
DIST_CURVE_SPLIT = (3, 2)
DIST_SMALL_ROWS = 1 << 20
# the sharded leg: two ranks on the card, each holding half of the retrieval
# leg's label axis and of the sliced leg's cohorts
SHARD_RANKS = 2
SHARD_LABELS = RETRIEVAL_LABELS // SHARD_RANKS
SHARD_COHORTS = SLICED_COHORTS // SHARD_RANKS
SHARD_TIMEOUT_S = 600
# BASELINE config 1 (bench.py:498-553): 200 batches of (8192, 5) scores
SMALL_ROWS, SMALL_CLASSES, SMALL_BATCHES = 8192, 5, 200
# BASELINE config 3 (bench.py:639-733): 13 batches of 100,000 int32
# predictions and labels at C = 1000 (config 3 feeds one batch 13 times; the
# leg makes each batch distinct)
CM_CLASSES, CM_ROWS, CM_BATCHES = 1000, 100_000, 13
# the ImageNet-1k validation set's size at full width: 50,000 rows of 1000
# softmax scores, in 5 batches of 10,000
CURVE_ROWS, CURVE_CLASSES, CURVE_BATCHES = 10_000, 1000, 5
CURVE_COMPACTION = 20_000
CURVE_THRESHOLDS = 100
TARGET_DENSITY = 1e-3
CRITERIA = ("exact_match", "hamming", "overlap", "contain", "belong")
# H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
RTOL, ATOL = 1e-5, 1e-8
# the recommendation-eval leg: 16 batches of (3, 2^22) predictions, about one
# MLPerf DLRM evaluation pass over Criteo Terabyte's held-out day a task
REC_TASKS, REC_ROWS, REC_BATCHES, REC_WINDOW = 3, 1 << 22, 16, 8
REC_CLICK_RATE = 0.03
R2_ROWS, R2_OUTPUTS, R2_BATCHES = 1 << 22, 8, 4
R2_MODES = ("uniform_average", "raw_values", "variance_weighted")
QUANT_MODES = ("bf16", "int8")
SYNC_CAL_TASKS = 256
# the resilience phase: (a) saves phase 3's stream after chunks 4 and 8
# (keep_last=2) and resumes from chunk 8, (d) falls back to chunk 4; (b)
# saves the sliced leg after batch 8 and resumes to batch 16; (c) the kill
# drill on the data-parallel leg's data, 2 of each rank's 4 chunks before
# the fault, rank 1 killed entering round 3 with exit code 43
RES_FIRST_SAVE, RES_SAVE = 4, 8
RES_SLICED_SAVE, RES_SLICED_BATCHES = 8, SLICED_BATCHES
DRILL_PRE_CHUNKS = 2
DRILL_TIMEOUT_S = 30.0
DRILL_EXIT_CODE = 43
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
    """The deferred folds' counters, from the obs registry: window steps,
    those that folded batches, their batches, solo and group folds, their
    batches."""
    from torcheval_tpu_torch.utils.test_utils.obs_counts import count, folding_window_steps

    return (
        int(count("deferred.window_steps")), folding_window_steps(),
        int(count("deferred.window_step_batches")), int(count("deferred.folds")),
        int(count("deferred.folded_chunks")),
    )


class _KernelCounts:
    """Each hand kernel's launches since its count was last set to 0, read
    from the obs registry (the kernel's ``jit.calls{entry=}``, which its
    wrapper counts where it launches). ``K.hist = 0`` zeroes one count;
    ``K.hist`` reads it. A registry reset zeroes every count."""

    def __init__(self):
        object.__setattr__(self, "_base", {})

    @staticmethod
    def _now(entry):
        from torcheval_tpu_torch import obs
        from torcheval_tpu_torch.utils.test_utils.obs_counts import launches

        return obs.default_registry._generation, launches(entry)

    def __getattr__(self, entry):
        gen, n = self._now(entry)
        base_gen, base = self._base.get(entry, (gen, 0))
        return n - base if base_gen == gen else n

    def __setattr__(self, entry, value):
        _require(value == 0, "a launch count is set to 0 only")
        self._base[entry] = self._now(entry)


K = _KernelCounts()


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


class record_sketch_folds:
    """Context manager: every segment-sum launch of the sketch folds
    (``sketch/histogram.py`` and ``sketch/cache.py``) while it is open, as
    ``(N, D, segments)``. A call is recorded only where the kernel's launch
    count (``jit.calls{entry=segment_sum}``) rose across it: a call that ran
    the plain version or returned early is no launch."""

    def __enter__(self):
        from torcheval_tpu_torch.sketch import cache, histogram

        self.mods = (cache, histogram)
        self.saved = [m.segment_sum for m in self.mods]
        self.shapes = []
        real = self.saved[0]

        def counted(vals, rows, num_segments):
            before = K.segment_sum
            out = real(vals, rows, num_segments)
            if K.segment_sum > before:
                d = 1 if vals.ndim == 1 else int(np.prod(vals.shape[1:]))
                self.shapes.append((int(vals.shape[0]), d, int(num_segments)))
            return out

        for m in self.mods:
            m.segment_sum = counted
        return self

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.saved):
            m.segment_sum = f
        return False

    def count(self, n=None, d=None, segments=None) -> int:
        return sum(1 for sh in self.shapes
                   if (n is None or sh[0] == n) and (d is None or sh[1] == d)
                   and (segments is None or sh[2] == segments))


def _np_bucket_index(x: np.ndarray, bits: int) -> np.ndarray:
    """The float-prefix bucket of every float32 value, in numpy: the sign-
    aware order key of the bits (subnormals and -0.0 flushed to +0.0, NaN to
    the top key), its top ``bits`` bits."""
    x = np.where(np.abs(x) < np.finfo(np.float32).tiny, np.float32(0.0), x.astype(np.float32))
    b = x.view(np.uint32).astype(np.int64)
    key = np.where(b >= 1 << 31, b ^ 0xFFFFFFFF, b | (1 << 31))
    key = np.where(np.isnan(x), 0xFFFFFFFF, key)
    return key >> (32 - bits)


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


def check_classification_shapes(dev, gen):
    """The kernels at the shapes the config-3 and curve legs give them: the
    histogram over config 3's window of joint keys into C^2 = 10^6 bins and
    over one curve batch's binned keys into 2 * C * (T + 1) = 202,000 bins;
    the segment sum at the binned curve's stacked window (5 batches, one
    segment sum over 5 * 10^7 keys into 5 * 202,000 segments); and the
    per-class compaction (one stream compaction over the flattened C * M
    rows) bit for bit against the batched two-sort, at the curve leg's two
    fold widths. Every one exact."""
    from torcheval_tpu_torch.metrics.classification.auroc import _pad_cap
    from torcheval_tpu_torch.ops.hist import hist, hist_plain
    from torcheval_tpu_torch.ops.scatter import segment_sum, segment_sum_plain
    from torcheval_tpu_torch.ops.summary import compact_count_rows, compact_count_rows_fast

    c2 = CM_CLASSES * CM_CLASSES
    n = CM_BATCHES * CM_ROWS
    keys = torch.randint(0, CM_CLASSES, (n,), generator=gen, device=dev, dtype=torch.int32) * CM_CLASSES
    keys += torch.randint(0, CM_CLASSES, (n,), generator=gen, device=dev, dtype=torch.int32)
    keys[::1001] = -1  # a pair out of range
    bins = 2 * CURVE_CLASSES * (CURVE_THRESHOLDS + 1)
    binned = torch.randint(0, bins, (CURVE_ROWS * CURVE_CLASSES,), generator=gen, device=dev,
                           dtype=torch.int32)
    for name, labels, c in ((f"config 3's window, {n} int32 joint keys, C^2={c2}", keys, c2),
                            (f"one curve batch, {binned.numel()} int32 binned keys, {bins} bins",
                             binned, bins)):
        got, want = hist(labels, c), hist_plain(labels, c)
        torch.cuda.synchronize()
        _require(torch.equal(got, want), f"hist {name}")
        print(f"  hist {name}: exact")
    b = CURVE_BATCHES
    rows = (binned.to(torch.int64).repeat(b).reshape(b, -1)
            + torch.arange(b, device=dev)[:, None] * bins).reshape(-1)
    rows[::997] = -1
    ones = torch.ones(rows.shape[0], dtype=torch.int32, device=dev)
    got, want = segment_sum(ones, rows, b * bins), segment_sum_plain(ones, rows, b * bins)
    torch.cuda.synchronize()
    _require(torch.equal(got, want), "segment_sum at the binned window")
    print(f"  segment_sum int32 D=1 S={b * bins}, the binned curve's stacked window of "
          f"{rows.numel()} keys: exact")
    del keys, binned, rows, ones, got, want
    first = _pad_cap(CURVE_COMPACTION)
    for m in (first, _pad_cap(CURVE_COMPACTION + first)):  # the leg's two fold widths
        s = torch.rand((CURVE_CLASSES, m), generator=gen, device=dev)
        s = (s * 4096).floor() / 4096  # ties inside each class row
        s[:, -m // 8:] = float("nan")  # the padding a fold adds
        s[0, 1] = float("nan")  # a NaN sample
        s[1, :] = s[2, 0]  # a row that is one tie group, ending where the next starts
        tp = torch.randint(0, 3, (CURVE_CLASSES, m), generator=gen, device=dev, dtype=torch.int32)
        fp = torch.randint(0, 3, (CURVE_CLASSES, m), generator=gen, device=dev, dtype=torch.int32)
        tp[:, -m // 8:] = 0
        fp[:, -m // 8:] = 0
        want = compact_count_rows(s, tp, fp)
        got = compact_count_rows_fast(s, tp, fp)
        torch.cuda.synchronize()
        _require(torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)),
                 f"per-class compaction scores at ({CURVE_CLASSES}, {m})")
        for i in range(1, 5):
            _require(torch.equal(got[i], want[i]), f"per-class compaction output {i} at ({CURVE_CLASSES}, {m})")
        print(f"  per-class compaction ({CURVE_CLASSES}, {m}) = {CURVE_CLASSES * m} flattened rows, "
              f"{int(got[3].sum())} kept: bit-equal to the batched two-sort")
        del s, tp, fp, got, want


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
        ("label tile 64x500000 k=100", rand(RETRIEVAL_ROWS, SHARD_LABELS), 100),
        ("label tile 64x500000 k=10", rand(RETRIEVAL_ROWS, SHARD_LABELS), 10),
        ("ideal ranking, label tile 64x500000 k=100",
         (rand(RETRIEVAL_ROWS, SHARD_LABELS) < TARGET_DENSITY).float(), 100),
        ("row block 32x1000000 k=100", rand(RETRIEVAL_ROWS // SHARD_RANKS, RETRIEVAL_LABELS), 100),
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


def slice_tile_inputs(dev):
    """The segment sum's operands at the sharded sliced leg's tile shapes,
    as rank 1 of 2 sees them: (2^24, 2) int32 accuracy deltas with uniform
    cohort rows over 10^6, localised to the tile [500,000, 10^6) (so half
    are out of it, negative), into 500,000 segments; and the 4-bit sketch
    fold's (2^24,) int32 ones at ``local * 33 + plane``, -1 out of the
    tile, into 500,000 x 33. ``{name: (vals, rows, segments, what)}``."""
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    n = SLICED_BATCHES * SLICED_ROWS
    local = torch.randint(0, SLICED_COHORTS, (n,), generator=g, device=dev,
                          dtype=torch.int32) - SHARD_COHORTS
    deltas = torch.randint(0, 2, (n, 2), generator=g, device=dev, dtype=torch.int32)
    deltas[:, 1] = 1
    plane = torch.randint(0, SLICED_PLANES, (n,), generator=g, device=dev, dtype=torch.int32)
    ok = (local >= 0) & (local < SHARD_COHORTS)
    idx = torch.where(ok, local * SLICED_PLANES + plane, -1)
    return {
        "slice_tile": (deltas, local, SHARD_COHORTS,
                       f"({n}, 2) int32 deltas, uniform rows localised to a tile of "
                       f"{SHARD_COHORTS} cohorts (half out of it)"),
        "sketch_slice_tile": (torch.ones(n, dtype=torch.int32, device=dev), idx,
                              SHARD_COHORTS * SLICED_PLANES,
                              f"({n},) int32 ones into {SHARD_COHORTS} x {SLICED_PLANES} "
                              "(the tile's 4-bit sketch fold, half at -1)"),
    }


def check_slice_tiles(inputs):
    """The segment sum bit for bit against its plain version at the tile
    shapes (integers: exact). Returns the largest |kernel - plain|."""
    from torcheval_tpu_torch.ops.scatter import segment_sum, segment_sum_plain

    for name, (vals, rows, segments, what) in inputs.items():
        got = segment_sum(vals, rows, segments)
        _require(torch.equal(got, segment_sum_plain(vals, rows, segments)), f"segment_sum at {what}")
        torch.cuda.synchronize()
        print(f"  segment_sum at {what}: exact")
    return 0.0


def sketch_gen(dev):
    return torch.Generator(device=dev).manual_seed(SEED + 9)


def sketch_fold_inputs(dev, gen):
    """The segment sum's operands at the four sketch-fold shapes, made as
    the folds make them: the sliced window's 4-bit keys ``row * 33 + plane``
    (power-law rows over 10^6 cohorts, uniform scores) with int32 ones; a
    headline chunk's ``[t, 1 - t]`` lanes by 16-bit bucket; ``Quantile``'s
    stacked value fold of four headline chunks, int32 ones by ``r * 2^16 +
    bucket``; and an ImageNet-val batch's one-vs-all lanes by ``c * 4096 +
    bucket``."""
    from torcheval_tpu_torch.sketch import bucket_index

    rng = np.random.default_rng(SEED + 9)
    n = SLICED_BATCHES * SLICED_ROWS
    rows = torch.from_numpy(_zipf_rows(rng, n, SLICED_COHORTS)).to(dev, torch.int32)
    scores = torch.rand(n, generator=gen, device=dev)
    t = (torch.rand(n, generator=gen, device=dev) < 0.4).to(torch.int32)
    plane = 2 * bucket_index(scores, SLICED_BITS) + (1 - t)
    out = {"sliced": (torch.ones(n, dtype=torch.int32, device=dev), rows * SLICED_PLANES + plane,
                      SLICED_COHORTS * SLICED_PLANES,
                      f"({n},) int32 ones by row * {SLICED_PLANES} + plane into "
                      f"{SLICED_COHORTS} x {SLICED_PLANES} segments: the sliced window's "
                      f"{SLICED_BITS}-bit sketch fold")}
    logits = torch.rand(HEADLINE_CHUNK, generator=gen, device=dev)
    t = (torch.rand(HEADLINE_CHUNK, generator=gen, device=dev) < 0.2).to(torch.int32)
    out["binary"] = (torch.stack([t, 1 - t], dim=-1), bucket_index(logits, SKETCH_BITS),
                     1 << SKETCH_BITS,
                     f"({HEADLINE_CHUNK}, 2) int32 [t, 1 - t] by {SKETCH_BITS}-bit bucket into "
                     f"{1 << SKETCH_BITS} segments: a binary approx=True fold of a headline chunk")
    del logits, t
    n = QUANTILE_STACK * HEADLINE_CHUNK
    logits = torch.rand((QUANTILE_STACK, HEADLINE_CHUNK), generator=gen, device=dev)
    keys = (bucket_index(logits, SKETCH_BITS)
            + torch.arange(QUANTILE_STACK, dtype=torch.int32, device=dev)[:, None] * (1 << SKETCH_BITS))
    out["quantile"] = (torch.ones(n, dtype=torch.int32, device=dev), keys.reshape(-1),
                       QUANTILE_STACK << SKETCH_BITS,
                       f"({n},) int32 ones by r * {1 << SKETCH_BITS} + bucket into "
                       f"{QUANTILE_STACK} x {1 << SKETCH_BITS} segments: Quantile's stacked value "
                       f"fold of {QUANTILE_STACK} headline chunks")
    del logits, keys
    scores = torch.softmax(torch.randn((CURVE_ROWS, CURVE_CLASSES), generator=gen, device=dev) * 3, dim=1)
    labels = torch.randint(0, CURVE_CLASSES, (CURVE_ROWS,), generator=gen, device=dev)
    onehot = (labels[None, :] == torch.arange(CURVE_CLASSES, device=dev)[:, None]).to(torch.int32)
    b = 1 << MC_SKETCH_BITS
    keys = (bucket_index(scores.T, MC_SKETCH_BITS)
            + torch.arange(CURVE_CLASSES, dtype=torch.int32, device=dev)[:, None] * b)
    out["multiclass"] = (torch.stack([onehot, 1 - onehot], dim=-1).reshape(-1, 2), keys.reshape(-1),
                         CURVE_CLASSES * b,
                         f"({CURVE_ROWS * CURVE_CLASSES}, 2) int32 one-vs-all lanes by c * {b} + "
                         f"bucket into {CURVE_CLASSES} x {b} segments: a multiclass approx=True fold "
                         f"of an ImageNet-val batch")
    return out


def check_sketch_folds(dev, inputs):
    """The segment sum at the sketch folds' shapes against its plain version,
    bit for bit; ``bucket_index`` on the card against the CPU over the
    special values and random ones, as float32, bfloat16 and float16.
    Returns the largest |kernel - plain| (0)."""
    from torcheval_tpu_torch.ops.scatter import segment_sum, segment_sum_plain
    from torcheval_tpu_torch.sketch import bucket_index

    for name, (vals, rows, segments, what) in inputs.items():
        got = segment_sum(vals, rows, segments)
        want = segment_sum_plain(vals, rows, segments)
        torch.cuda.synchronize()
        _require(torch.equal(got, want), f"segment_sum at the {name} sketch shape")
        print(f"  segment_sum {what}: exact")
    tiny = float(np.finfo(np.float32).tiny)
    special = [0.0, -0.0, 1e-40, -1e-40, 1e-45, -1e-45, float(np.nextafter(np.float32(tiny), 0)),
               -float(np.nextafter(np.float32(tiny), 0)), tiny, -tiny, float("inf"), float("-inf"),
               float("nan"), 3.4e38, -3.4e38, 0.5, -0.5, 1.0]
    g = torch.Generator().manual_seed(SEED)
    x = torch.cat([torch.tensor(special, dtype=torch.float32),
                   torch.randn(1 << 20, generator=g) * 1e3, torch.rand(1 << 20, generator=g)])
    cases = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        xs = x.to(dtype)
        for bits in (SLICED_BITS, 10, MC_SKETCH_BITS, SKETCH_BITS, 20):
            _require(torch.equal(bucket_index(xs.to(dev), bits).cpu(), bucket_index(xs, bits)),
                     f"bucket_index on the card, {dtype} at {bits} bits")
            cases += 1
    print(f"  bucket_index on the card equals the CPU's over {len(special)} special values and "
          f"2^21 random ones, float32, bfloat16 and float16, at 5 widths ({cases} cases)")
    return 0.0


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


# ------------------------------------------------ the obs phase
OBS_RUNS = 3
# the obs phase's small-batch data comes from its own seed: the legs after
# it keep the batches phase 4 has always made
OBS_SMALL_SEED = SEED + 1400
# a Prometheus text-format sample line: name, optional labels, one value
_PROM_SAMPLE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*"(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\.)*")*\})?'
    r' (?:[-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|\.\d+(?:e[-+]?\d+)?|Inf|NaN))$')


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def obs_on_off(dev, chunks, want, small):
    """(a) The headline run ``OBS_RUNS`` times with obs off and as often on,
    alternating, timed with CUDA events: both values equal phase 3's bit
    for bit in every run; then the same for the small-batch leg (its values
    equal in every run). Returns the preds/s (rows/s) of each."""
    from torcheval_tpu_torch import obs

    total = HEADLINE_CHUNKS * HEADLINE_CHUNK
    n_small = SMALL_BATCHES * SMALL_ROWS
    rates = {"headline": {False: [], True: []}, "small": {False: [], True: []}}
    small_batch_leg(dev, small)  # warm-up
    small_want = None
    try:
        for i in range(2 * OBS_RUNS):
            on = bool(i % 2)
            (obs.enable if on else obs.disable)()
            acc, acc_v, auroc_v, seconds, _, _ = headline_leg(dev, chunks)
            del acc
            _require((acc_v, auroc_v) == want,
                     f"(a) obs {'on' if on else 'off'}: accuracy and AUROC {(acc_v, auroc_v)} equal "
                     f"phase 3's {want} bit for bit")
            rates["headline"][on].append(total / seconds)
        for i in range(2 * OBS_RUNS):
            on = bool(i % 2)
            (obs.enable if on else obs.disable)()
            col, out, seconds, _ = small_batch_leg(dev, small)
            got = (float(out["accuracy"]), float(out["f1_macro"]))
            small_want = small_want or got
            _require(got == small_want, f"(a) small-batch values {got} equal {small_want} bit for bit")
            rates["small"][on].append(n_small / seconds)
            del col, out
    finally:
        obs.enable()
    return rates


class _CountedEntries:
    """Context manager: the calls of the kernels' C entry points (an
    independent count of launches, below the wrappers) and each compaction
    launch's row count."""

    NAMES = ("tc_hist_i32", "tc_hist_i64", "tc_stream_compact")

    def __enter__(self):
        from torcheval_tpu_torch import _build

        self.lib = _build.library()
        self.calls = {n: 0 for n in self.NAMES}
        self.compact_rows = []
        self.saved = {n: getattr(self.lib, n) for n in self.NAMES}

        def counting(name, fn):
            def call(*args):
                self.calls[name] += 1
                if name == "tc_stream_compact":
                    self.compact_rows.append(int(args[1]))
                return fn(*args)

            return call

        for n, fn in self.saved.items():
            setattr(self.lib, n, counting(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.lib, n, fn)
        return False


class _Warnings(logging.Handler):
    """The warnings the telemetry logger emits while it is attached."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def obs_registry_check(dev, chunks, want, headline_launches):
    """(b) What the registry holds after one enabled headline run (reset
    first): the per-metric spans, the launches (against the C entry points'
    calls and phase 3's counts), the watchdog's first sights and no storm,
    the compaction's cost gauge against phase 5's byte count, a Chrome trace
    that parses with nested spans, and Prometheus text in the exposition
    format."""
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.utils.test_utils.obs_counts import count, launches, parse_key

    obs.reset()
    logger = logging.getLogger("torcheval_tpu_torch.api_usage")
    warned = _Warnings()
    logger.addHandler(warned)
    try:
        with _CountedEntries() as entries:
            acc, acc_v, auroc_v, _, _, _ = headline_leg(dev, chunks)
    finally:
        logger.removeHandler(warned)
    del acc
    _require((acc_v, auroc_v) == want, "(b) the enabled run's values equal phase 3's")
    snap = obs.snapshot()
    spans = snap["spans"]
    for cls in ("MulticlassAccuracy", "BinaryAUROC"):
        n_update = spans.get(f"metric.update/{cls}", {}).get("count", 0)
        n_compute = spans.get(f"metric.compute/{cls}", {}).get("count", 0)
        _require(n_update == HEADLINE_CHUNKS and n_compute == 1,
                 f"(b) {cls}: {n_update} update spans (want {HEADLINE_CHUNKS}), {n_compute} compute")
    c_hist = entries.calls["tc_hist_i32"] + entries.calls["tc_hist_i64"]
    got = {"hist": launches("hist", snap), "stream_compact": launches("stream_compact", snap),
           "compact_summary_rows": int(count("jit.calls", snap, entry="compact_summary_rows"))}
    _require(got["hist"] == c_hist == headline_launches["hist"],
             f"(b) jit.calls{{entry=hist}} {got['hist']}, C entry calls {c_hist}, phase 3 "
             f"{headline_launches['hist']}")
    _require(got["compact_summary_rows"] == 2
             and got["stream_compact"] == entries.calls["tc_stream_compact"] == 2,
             f"(b) the headline's two compactions: {got}, C entry calls {entries.calls}")
    traces = {parse_key(k)[1]["entry"]: int(v) for k, v in snap["counters"].items()
              if parse_key(k)[0] == "recompile.traces"}
    _require(traces and max(traces.values()) <= 2, f"(b) at most 2 first sights an entry: {traces}")
    storms = [m for m in warned.messages if "Retrace storm" in m]
    _require(not storms, f"(b) no storm warning: {storms}")
    n = entries.compact_rows[-1]
    compact_bytes = n * (1 + 3 * 4 + 3 * 4) + 4  # phase 5's byte count, a bool mask
    gauges = snap["gauges"]
    for entry in ("compact_summary_rows", "stream_compact"):
        g = gauges.get(f"obs.cost.bytes_accessed{{entry={entry}}}")
        _require(g == compact_bytes, f"(b) obs.cost.bytes_accessed{{entry={entry}}} {g} vs {compact_bytes}")
    trace = json.loads(obs.chrome_trace())
    spans_x = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    inner = [e for e in spans_x if e["name"] == "metric.update/BinaryAUROC/jit/compact_summary_rows"]
    outer = [e for e in spans_x if e["name"] == "metric.update/BinaryAUROC"]
    _require(len(inner) == 2 and all(
        any(o["tid"] == e["tid"] and o["ts"] <= e["ts"] and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
            for o in outer) for e in inner),
        f"(b) the compaction spans nest inside BinaryAUROC's update spans ({len(inner)} of them)")
    text = obs.prometheus_text()
    samples = [line for line in text.splitlines() if line and not line.startswith("#")]
    bad = [line for line in samples if not _PROM_SAMPLE.match(line)]
    _require(samples and not bad, f"(b) Prometheus sample lines in the exposition format: {bad[:3]}")
    return {"spans": len(spans), "launches": got, "c_entry_calls": dict(entries.calls),
            "compact_rows": list(entries.compact_rows), "traces": traces,
            "compact_bytes": compact_bytes, "trace_events": len(trace["traceEvents"]),
            "prometheus_lines": len(samples)}


_RANGES = ("metric.", "collection.", "jit/")


def obs_profile(dev, chunks):
    """(c) One enabled headline run under ``torch.profiler`` (CUDA activity
    on): every histogram and compaction kernel was launched (its CUDA
    runtime call, matched by correlation id) inside a ``metric.*``,
    ``collection.*`` or ``jit/<entry>`` range; device ms of the kernels,
    copies and fills by the outermost such range (per metric) and by the
    innermost."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        acc, *_ = headline_leg(dev, chunks)
        del acc
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    ranges = [e for e in events if e.device_type == cpu and e.name.startswith(_RANGES)]
    # a device event and the runtime call that enqueued it share an id
    calls = {e.id: e.time_range.start for e in events
             if e.device_type == cpu and e.name.startswith("cu")}
    watched = ("hist_kernel", "compact_kernel")
    outer_ms, inner_ms, unranged = defaultdict(float), defaultdict(float), defaultdict(float)
    kernels, outside, device_ms = 0, [], 0.0
    for d in events:
        # the profiler mirrors each range onto the device timeline under the
        # range's own name (a span over its kernels): not work of its own
        if d.device_type != cuda or d.name.startswith(_RANGES):
            continue
        ms = d.time_range.elapsed_us() / 1e3
        device_ms += ms
        t = calls.get(d.id)
        around = [] if t is None else sorted(
            (r for r in ranges if r.time_range.start <= t <= r.time_range.end),
            key=lambda r: r.time_range.elapsed_us())
        if around:
            inner_ms[around[0].name] += ms
            outer_ms[around[-1].name] += ms
        else:
            inner_ms["(no range)"] += ms
            outer_ms["(no range)"] += ms
            key = d.name[:48] + ("" if t is not None else " (no runtime call found)")
            unranged[key] += ms
        if any(w in d.name for w in watched):
            kernels += 1
            if not around:
                outside.append(d.name[:60])
    _require(kernels >= 2 and not outside,
             f"(c) {kernels - len(outside)} of {kernels} hist/compaction kernels launched inside a "
             f"metric, collection or jit range; outside: {outside[:3]}")
    top = sorted(unranged.items(), key=lambda kv: -kv[1])[:6]
    return {"kernels": kernels, "outer_ms": dict(outer_ms), "inner_ms": dict(inner_ms),
            "device_ms": device_ms, "unranged": {k: round(v, 3) for k, v in top}}


# ------------------------------------------------ phase 4, approximate legs
def approx_headline_leg(dev, chunks):
    """``BinaryAUROC(approx=True)``, ``BinaryAUPRC(approx=True)`` and
    ``Quantile(q=(0.5, 0.9, 0.99))`` over the headline's binary logits, from
    the first ``update()`` to the three ``compute()`` results. The peak
    memory comes as (peak, peak above what was allocated at the start: the
    leg's own)."""
    from torcheval_tpu_torch.metrics import BinaryAUPRC, BinaryAUROC, Quantile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    auroc = BinaryAUROC(approx=True, device=dev)
    auprc = BinaryAUPRC(approx=True, device=dev)
    quantile = Quantile(q=QUANTILES, device=dev)
    for _, _, logits, binary in chunks:
        auroc.update(logits, binary)
        auprc.update(logits, binary)
        quantile.update(logits)
    out = auroc.compute(), auprc.compute(), quantile.compute()
    end.record()
    end.synchronize()
    host_seconds = time.perf_counter() - t0
    values = (float(out[0]), float(out[1]), out[2].tolist())
    peak = torch.cuda.max_memory_allocated(dev)
    return ((auroc, auprc, quantile), values, start.elapsed_time(end) / 1e3, host_seconds,
            (peak, peak - base))


def _average_precision_on_card(x, t):
    """``_average_precision``'s formula in float64 on the card (the stream
    is 2^28 samples): unique descending thresholds, per-threshold counts,
    ``sum(tp * precision) / P``."""
    uniq, inv = torch.unique(-x, return_inverse=True)
    tp = torch.bincount(inv, weights=t.double(), minlength=uniq.numel())
    fp = torch.bincount(inv, weights=(1 - t).double(), minlength=uniq.numel())
    ctp, cfp = torch.cumsum(tp, 0), torch.cumsum(fp, 0)
    return float(torch.sum(tp * ctp / (ctp + cfp)) / t.double().sum())


def check_approx_headline(chunks, metrics, values, exact_auroc):
    """The sketch's counts sum to the stream; AUROC within the sketch's
    ``auroc_error_bound`` of phase 3's exact AUROC, AUPRC within its
    ``auprc_error_bound`` of the exact average precision; each quantile
    within ``relative_error(16)`` of the inverted-CDF order statistic of a
    ``torch.sort`` on the card. Returns the errors and bounds."""
    from torcheval_tpu_torch.sketch import auprc_error_bound, auroc_error_bound, relative_error

    auroc, auprc, quantile = metrics
    auroc._compact()
    auprc._compact()
    total = HEADLINE_CHUNKS * HEADLINE_CHUNK
    for name, m in (("AUROC", auroc), ("AUPRC", auprc)):
        got = int(m.sketch_tp.sum(dtype=torch.int64)) + int(m.sketch_fp.sum(dtype=torch.int64))
        _require(got == total and int(m.sketch_nan_dropped) == 0, f"{name} sketch counts {got} sum to {total}")
    _require(int(quantile.bucket_counts.sum(dtype=torch.int64)) == total, "Quantile counts sum to 2^28")
    x = torch.cat([c[2] for c in chunks])
    t = torch.cat([c[3] for c in chunks])
    out = {"auroc_bound": auroc_error_bound(auroc.sketch_tp, auroc.sketch_fp),
           "auprc_bound": auprc_error_bound(auprc.sketch_tp, auprc.sketch_fp),
           "auroc_err": abs(values[0] - exact_auroc)}
    ap = _average_precision_on_card(x, t)
    out["auprc_exact"] = ap
    out["auprc_err"] = abs(values[1] - ap)
    # 1e-6: the float32 rounding of the two computes, as the JAX tests allow
    _require(out["auroc_err"] <= out["auroc_bound"] + 1e-6,
             f"approx AUROC {values[0]} vs exact {exact_auroc}: bound {out['auroc_bound']}")
    _require(out["auprc_err"] <= out["auprc_bound"] + 1e-6,
             f"approx AUPRC {values[1]} vs exact {ap}: bound {out['auprc_bound']}")
    ordered = torch.sort(x).values
    out["quantile_rel_err"] = []
    for q, got in zip(QUANTILES, values[2]):
        true = float(ordered[max(int(np.ceil(q * total)) - 1, 0)])
        rel = abs(got - true) / abs(true) if true else abs(got)
        _require(abs(got - true) <= relative_error(SKETCH_BITS) * abs(true) + 1.2e-38,
                 f"quantile {q}: {got} vs order statistic {true}")
        out["quantile_rel_err"].append(rel)
    del ordered, x, t
    return out


def approx_curve_leg(dev, batches):
    """``MulticlassAUROC(1000, approx=True)`` and ``MulticlassAUPRC(1000,
    approx=True)`` (2^12 buckets, one staged fold a batch), from the first
    ``update()`` to both ``compute()`` results; the peak memory as in
    :func:`approx_headline_leg`."""
    from torcheval_tpu_torch.metrics import MulticlassAUPRC, MulticlassAUROC

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = tuple(cls(num_classes=CURVE_CLASSES, average=None, approx=True,
                        compaction_threshold=CURVE_ROWS, device=dev)
                    for cls in (MulticlassAUROC, MulticlassAUPRC))
    for scores, labels in batches:
        for m in metrics:
            m.update(scores, labels)
    out = tuple(m.compute() for m in metrics)
    end.record()
    end.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    return metrics, out, start.elapsed_time(end) / 1e3, (peak, peak - base)


def check_approx_curve(metrics, out, exact):
    """Every class within its sketch's error bound of the exact per-class
    AUROC and AUPRC the curve leg computed. Returns the largest error and
    the largest bound of each."""
    from torcheval_tpu_torch.sketch import auprc_error_bound, auroc_error_bound

    worst = {}
    for name, m, got, want, bound_fn in (("auroc", metrics[0], out[0], exact[0], auroc_error_bound),
                                         ("auprc", metrics[1], out[1], exact[1], auprc_error_bound)):
        tp, fp = m.sketch_tp.cpu().numpy(), m.sketch_fp.cpu().numpy()
        got, want = got.cpu().numpy().astype(np.float64), want.cpu().numpy().astype(np.float64)
        errs, bounds = np.abs(got - want), np.array([bound_fn(tp[c], fp[c]) for c in range(CURVE_CLASSES)])
        bad = np.nonzero(errs > bounds + 1e-6)[0]
        _require(bad.size == 0, f"approx {name} of class {bad[:1]} outside its bound")
        worst[name] = (float(errs.max()), float(bounds.max()))
    return worst


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


def retrieval_leg_data(dev):
    """The retrieval leg's batches, from their own seed: the sharded leg's
    ranks make the same ones."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
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


def sliced_leg_data(dev):
    """``bench.py:2039-2047``, seeded: every cohort once (registration), then
    power-law traffic, ids made sparse by ``id * 7919 + 13``; scores and
    targets on the card, ids on the host (interning needs host bytes). From
    their own seeds: the sharded leg's ranks make the same rows."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
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


def sliced_setup(dev, data, **mesh_kw):
    """Both collections, with every cohort registered by batch 0: bench.py's
    ``config11_sliced`` pair (accuracy and a 4-bit AUROC sketch a cohort)
    and the ``Mean``/``Max`` pair beside it; ``mesh_kw`` (``mesh``,
    ``mesh_axis``) shards their slice axis. The registration batch folds
    before the function returns (no collective: each member folds alone)."""
    from torcheval_tpu_torch.metrics import (
        BinaryAccuracy,
        BinaryAUROC,
        Max,
        Mean,
        SlicedMetricCollection,
    )

    acc = SlicedMetricCollection(
        {"acc": BinaryAccuracy(device=dev), "auroc": BinaryAUROC(approx=1024, device=dev)},
        capacity=SLICED_COHORTS,
        curve_bucket_bits=SLICED_BITS,
        **mesh_kw,
    )
    agg = SlicedMetricCollection({"mean": Mean(device=dev), "max": Max(device=dev)},
                                 capacity=SLICED_COHORTS, **mesh_kw)
    ids, s, t = _sliced_batch(data, 0)
    acc.update(ids, s, t)
    agg.update(ids, s)
    for col in (acc, agg):
        for m in col.metrics.values():
            m._fold_now()
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
    from torcheval_tpu_torch.metrics import BinaryAccuracy, BinaryAUROC, Max, Mean, MetricCollection

    acc = MetricCollection({"acc": BinaryAccuracy(device=dev),
                            "auroc": BinaryAUROC(approx=1024, device=dev)})
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


def _first_seen_rows(ids):
    """Each sample's cohort row in first-seen order, the unique ids in that
    order, and the cohort count."""
    uniq, first, inv = np.unique(ids, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    row_of = np.empty(uniq.shape[0], np.int64)
    row_of[order] = np.arange(uniq.shape[0])
    return row_of[inv.reshape(-1)], uniq[order], uniq.shape[0]


def check_sliced_leg(data, member, results):
    """Per cohort, against numpy over all 17 batches: the slice ids in
    first-seen order, the accuracy ``member``'s num_correct and num_total
    (attributes in the unsharded layout) exactly, the maxima exactly, the
    means within rtol 1e-5 of float64."""
    ids, scores, targets = data
    s, t = scores.cpu().numpy(), targets.cpu().numpy()
    rows, first_seen, n = _first_seen_rows(ids)
    _require(np.array_equal(results["acc"].slice_ids, first_seen), "slice ids in first-seen order")
    correct = ((s >= 0.5).astype(np.float32) == t)
    want_correct = np.bincount(rows, weights=correct, minlength=n).astype(np.int64)
    want_total = np.bincount(rows, minlength=n).astype(np.int64)
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


def _sliced_sketch_against_numpy(rows, n, s, t, member, got, bits, pick):
    """One sliced AUROC sketch member against numpy: ``sketch_tp``,
    ``sketch_fp`` and the NaN count equal to ``np.bincount(rows * (2B + 1) +
    plane)`` exactly, with ``plane = 2 * bucket + (1 - target)``; each
    cohort's AUROC ``got`` within rtol 1e-5 of a float64 trapezoid over
    those counts; and for the cohorts ``pick`` (row numbers; None: 64 with
    both classes, drawn with the seed), |sketch - exact Mann-Whitney AUROC|
    within the sketch's ``auroc_error_bound``. Returns the largest trapezoid
    error, the picked cohorts' largest error and bound, the smallest
    distance of their exact AUROC from 0.5, and the count of occupied
    buckets over all cohorts."""
    from torcheval_tpu_torch.sketch import auroc_error_bound

    b = 1 << bits
    planes = 2 * b + 1
    plane = np.where(np.isnan(s), 2 * b, 2 * _np_bucket_index(s, bits) + (1 - t.astype(np.int64)))
    counts = np.bincount(rows * planes + plane, minlength=n * planes).reshape(n, planes)
    tp, fp = counts[:, 0:2 * b:2], counts[:, 1:2 * b:2]
    _require(np.array_equal(member.sketch_tp[:n].cpu().numpy(), tp)
             and np.array_equal(member.sketch_fp[:n].cpu().numpy(), fp)
             and np.array_equal(member.sketch_nan_dropped[:n].cpu().numpy(), counts[:, 2 * b]),
             f"per-cohort {bits}-bit sketch counts equal np.bincount(rows * {planes} + plane)")
    ctp = np.cumsum(tp[:, ::-1], 1, dtype=np.float64)
    cfp = np.cumsum(fp[:, ::-1], 1, dtype=np.float64)
    zero = np.zeros((n, 1))
    x, y = np.hstack([zero, cfp]), np.hstack([zero, ctp])
    area = np.sum((x[:, 1:] - x[:, :-1]) * (y[:, 1:] + y[:, :-1]) / 2, 1)
    pn = ctp[:, -1] * cfp[:, -1]
    want = np.where(pn == 0, 0.5, area / np.maximum(pn, 1))
    err = np.abs(got - want)
    _require(bool(np.all(err <= ATOL + RTOL * np.abs(want))),
             f"per-cohort {bits}-bit sketch AUROC vs float64 trapezoid (largest error {err.max():.3e})")
    if pick is None:
        eligible = np.nonzero(pn > 0)[0]
        pick = np.random.default_rng(SEED).choice(eligible, min(SLICED_SAMPLE_COHORTS, eligible.size),
                                                  replace=False)
    order = np.argsort(rows, kind="stable")
    starts = np.searchsorted(rows[order], pick)
    ends = np.searchsorted(rows[order], pick, side="right")
    worst_err = worst_bound = 0.0
    least_margin = 0.5
    for c, lo, hi in zip(pick, starts, ends):
        idx = order[lo:hi]
        exact = _mann_whitney_auc(s[idx].astype(np.float64), t[idx])
        bound = auroc_error_bound(tp[c], fp[c])
        _require(abs(got[c] - exact) <= bound + 1e-6,
                 f"cohort row {c}: {bits}-bit sketch AUROC {got[c]} vs exact {exact}, bound {bound}")
        worst_err, worst_bound = max(worst_err, abs(got[c] - exact)), max(worst_bound, bound)
        least_margin = min(least_margin, abs(exact - 0.5))
    return float(err.max()), worst_err, worst_bound, least_margin, int(np.count_nonzero(tp + fp))


def check_sliced_sketch(data, member, results):
    """The AUROC sketch ``member`` (its states as attributes, in the
    unsharded layout) per cohort, against numpy over all 17 batches
    (:func:`_sliced_sketch_against_numpy`, 64 sampled cohorts).
    Returns the largest trapezoid error, the sampled cohorts' largest error
    and bound, and the count of occupied buckets over all cohorts."""
    ids, scores, targets = data
    s, t = scores.cpu().numpy(), targets.cpu().numpy()
    rows, first_seen, n = _first_seen_rows(ids)
    _require(np.array_equal(results["auroc"].slice_ids, first_seen), "sketch slice ids in first-seen order")
    got = results["auroc"]["values"].cpu().numpy().astype(np.float64)
    trap_err, worst_err, worst_bound, _, occupied = _sliced_sketch_against_numpy(
        rows, n, s, t, member, got, SLICED_BITS, None)
    return trap_err, worst_err, worst_bound, occupied


def spread_sketch_data(n_rows, n_cohorts, seed):
    """Sparse cohort ids, scores that cover every bucket of a float-prefix
    sketch (``sign(u) * 2^(250 |u| - 125)``, u uniform on (-1, 1): the score
    rises with u through every normal exponent of both signs) and targets
    drawn with probability ``(1 + u) / 2``, so each cohort's AUROC stands
    well away from 0.5."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_cohorts, n_rows).astype(np.int64) * 7919 + 3
    u = rng.uniform(-1.0, 1.0, n_rows)
    s = (np.sign(u) * np.exp2(250.0 * np.abs(u) - 125.0)).astype(np.float32)
    t = (rng.random(n_rows) < (1.0 + u) / 2.0).astype(np.float32)
    return ids, s, t


# the spread check's largest sketch error bound a cohort may show, per
# width, and the least distance of its exact AUROCs (about 0.82) from 0.5
SPREAD_BOUNDS = {4: 0.05, 10: 0.001}
SPREAD_MARGIN = 0.25


def check_sliced_sketch_spread(dev):
    """The sliced AUROC sketch member over :func:`spread_sketch_data` (2^20
    rows over 256 cohorts, four batches) at 4 and 10 bits, every cohort
    against numpy (:func:`_sliced_sketch_against_numpy`). The error bounds
    must be well below the exact AUROC's distance from 0.5, so a flipped,
    reordered or misplaced curve cannot pass. Returns, per width, the
    largest trapezoid error, largest error and bound against Mann-Whitney,
    and the occupied buckets."""
    from torcheval_tpu_torch.metrics import BinaryAUROC, SlicedMetricCollection

    ids, s, t = spread_sketch_data(1 << 20, 256, SEED + 11)
    rows, first_seen, n = _first_seen_rows(ids)
    out = {}
    for bits in (4, 10):
        col = SlicedMetricCollection({"auroc": BinaryAUROC(approx=1024, device=dev)},
                                     capacity=1024, curve_bucket_bits=bits)
        for part in np.array_split(np.arange(ids.size), 4):
            col.update(ids[part], torch.from_numpy(s[part]).to(dev), torch.from_numpy(t[part]).to(dev))
        res = col.compute()["auroc"]
        _require(np.array_equal(res.slice_ids, first_seen), f"{bits}-bit spread slice ids in first-seen order")
        got = res["values"].cpu().numpy().astype(np.float64)
        trap_err, worst_err, worst_bound, margin, occupied = _sliced_sketch_against_numpy(
            rows, n, s, t, col.metrics["auroc"], got, bits, np.arange(n))
        _require(worst_bound <= SPREAD_BOUNDS[bits] and margin > SPREAD_MARGIN,
                 f"{bits}-bit spread: bound {worst_bound} <= {SPREAD_BOUNDS[bits]}, "
                 f"exact AUROC {margin} from 0.5")
        out[bits] = (trap_err, worst_err, worst_bound, occupied)
        print(f"  sliced {bits}-bit AUROC sketch over spread scores ({ids.size} rows, {n} cohorts, "
              f"{occupied} occupied (cohort, bucket) pairs): counts equal numpy, AUROC within "
              f"{trap_err:.3e} of the float64 trapezoid, every cohort within its bound of the exact "
              f"Mann-Whitney value (largest error {worst_err:.3e}, largest bound {worst_bound:.3e}, "
              f"exact values at least {margin:.3f} from 0.5)")
    return out


# ------------------------------------------------ phase 4, config-3 leg
def cm_leg_data(dev, gen):
    """BASELINE config 3's 13 batches, each distinct, made on the card."""
    return [
        (torch.randint(0, CM_CLASSES, (CM_ROWS,), generator=gen, device=dev, dtype=torch.int32),
         torch.randint(0, CM_CLASSES, (CM_ROWS,), generator=gen, device=dev, dtype=torch.int32))
        for _ in range(CM_BATCHES)
    ]


def cm_leg(dev, batches, collection: bool):
    """``MulticlassConfusionMatrix(1000)`` and macro ``MulticlassF1Score``,
    in one ``MetricCollection`` (bench.py's ``_fused`` form) or standalone,
    from the first ``update()`` to both ``compute()`` results."""
    from torcheval_tpu_torch.metrics import (
        MetricCollection,
        MulticlassConfusionMatrix,
        MulticlassF1Score,
    )

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    cm = MulticlassConfusionMatrix(CM_CLASSES, device=dev)
    f1 = MulticlassF1Score(num_classes=CM_CLASSES, average="macro", device=dev)
    if collection:
        col = MetricCollection({"cm": cm, "f1": f1})
        for pred, label in batches:
            col.update(pred, label)
        out = col.compute()
        mat, f1_v = out["cm"], out["f1"]
    else:
        for pred, label in batches:
            cm.update(pred, label)
            f1.update(pred, label)
        mat, f1_v = cm.compute(), f1.compute()
    end.record()
    end.synchronize()
    return mat, float(f1_v), start.elapsed_time(end) / 1e3


def _macro_from_matrix(mat: np.ndarray):
    """Macro F1, precision and recall of a count matrix in float64, with the
    metrics' rules: a class with neither a label nor a prediction leaves
    the mean; an undefined precision or recall counts as 0."""
    tp = np.diag(mat).astype(np.float64)
    label = mat.sum(1).astype(np.float64)
    pred = mat.sum(0).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(pred > 0, tp / pred, np.nan)
        r = np.where(label > 0, tp / label, np.nan)
        f1 = np.nan_to_num(2 * p * r / (p + r))
    mask = (label > 0) | (pred > 0)
    return {
        "f1": float(f1[mask].sum() / mask.sum()),
        "precision": float(np.nan_to_num(p)[mask].sum() / mask.sum()),
        "recall": float(np.nan_to_num(r)[mask].sum() / mask.sum()),
    }


def check_cm_leg(batches, mat, f1_v):
    """The matrix exactly against ``torch.bincount(label * C + pred)`` over
    all batches, F1 within rtol 1e-5 of its float64 value from that matrix.
    Returns the float64 macro values."""
    c = CM_CLASSES
    want = torch.zeros(c * c, dtype=torch.int64, device=batches[0][0].device)
    for pred, label in batches:
        want += torch.bincount(label.long() * c + pred.long(), minlength=c * c)
    _require(mat.dtype == torch.int32 and torch.equal(mat.long().reshape(-1), want),
             "config-3 confusion matrix vs torch.bincount")
    ref = _macro_from_matrix(want.reshape(c, c).cpu().numpy())
    _require(_close(f1_v, ref["f1"]), f"config-3 macro F1 {f1_v} vs float64 {ref['f1']}")
    return ref


def cm_information(dev, batches, ref):
    """Macro ``MulticlassPrecision`` and ``MulticlassRecall`` on the same
    batches (information, untimed), held to the matrix's float64 values."""
    from torcheval_tpu_torch.metrics import MulticlassPrecision, MulticlassRecall

    out = {}
    for name, cls in (("precision", MulticlassPrecision), ("recall", MulticlassRecall)):
        m = cls(num_classes=CM_CLASSES, average="macro", device=dev)
        for pred, label in batches:
            m.update(pred, label)
        out[name] = float(m.compute())
        _require(_close(out[name], ref[name]), f"config-3 macro {name} {out[name]} vs {ref[name]}")
    return out


# ------------------------------------------- phase 4, recommendation-eval leg
def rec_leg_data(dev):
    """16 batches of (3, 2^22) float32 logits, {0, 1} targets at a 3% click
    rate and float32 weights in [0.5, 1.5), from a seed of their own; the
    logits lean towards the clicks, as a trained model's do."""
    g = torch.Generator(device=dev).manual_seed(SEED + 600)
    out = []
    for _ in range(REC_BATCHES):
        t = (torch.rand((REC_TASKS, REC_ROWS), generator=g, device=dev) < REC_CLICK_RATE).to(torch.float32)
        x = torch.randn((REC_TASKS, REC_ROWS), generator=g, device=dev) + 2.0 * t - 3.5
        w = torch.rand((REC_TASKS, REC_ROWS), generator=g, device=dev) + 0.5
        out.append((x, t, w))
    return out


def rec_leg(dev, batches):
    """The five recommendation metrics over the leg's batches. Their
    ``update`` signatures differ (NE takes logits, targets and a ``weight=``
    keyword; CTR the clicks and weights; calibration probabilities, targets
    and weights), so they ride three ``MetricCollection``s, one per
    signature, each a deferred window. The calibration's probabilities are
    the logits' sigmoid, made inside the timed loop. Returns the results,
    the preds/s of a ``Throughput`` fed the CUDA-event time, the host
    seconds, the peak memory and the fold cadence."""
    from torcheval_tpu_torch.metrics import (
        BinaryNormalizedEntropy,
        ClickThroughRate,
        MetricCollection,
        Throughput,
        WeightedCalibration,
        WindowedClickThroughRate,
        WindowedWeightedCalibration,
    )

    kw = dict(num_tasks=REC_TASKS, device=dev)
    ne = MetricCollection({"ne": BinaryNormalizedEntropy(from_logits=True, **kw)})
    ctr = MetricCollection({"ctr": ClickThroughRate(**kw),
                            "wctr": WindowedClickThroughRate(window_size=REC_WINDOW, **kw)})
    cal = MetricCollection({"cal": WeightedCalibration(**kw),
                            "wcal": WindowedWeightedCalibration(window_size=REC_WINDOW, **kw)})
    throughput = Throughput(device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    folds0 = fold_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for x, t, w in batches:
        ne.update(x, t, weight=w)
        ctr.update(t, w)
        cal.update(torch.sigmoid(x), t, w)
    out = {**ne.compute(), **ctr.compute(), **cal.compute()}
    end.record()
    end.synchronize()
    host_s = time.perf_counter() - t0
    preds = REC_BATCHES * REC_TASKS * REC_ROWS
    throughput.update(preds, start.elapsed_time(end) / 1e3)
    return {
        "out": out, "preds": preds, "rate": float(throughput.compute()),
        "elapsed_s": float(throughput.elapsed_time_sec), "num_total": float(throughput.num_total),
        "host_s": host_s, "peak_bytes": torch.cuda.max_memory_allocated(dev),
        "cadence": cadence(folds0),
        "windows": [len(ctr.metrics["wctr"].window), len(cal.metrics["wcal"].window)],
    }


def rec_reference(batches):
    """Per task, in float64 on the card and not through the port: the
    weighted click, prediction and cross-entropy sums of every batch, then
    CTR, calibration and NE over all batches and over the last
    ``REC_WINDOW``."""
    stats = []
    for x, t, w in batches:
        xd, td, wd = x.double(), t.double(), w.double()
        pd = torch.sigmoid(x).double()
        ce = torch.nn.functional.softplus(xd) - xd * td
        stats.append(torch.stack([wd.sum(1), (wd * td).sum(1), (wd * pd).sum(1), (wd * ce).sum(1)]))

    def rates(part):
        sw, swt, swp, sce = torch.stack(part).sum(0)
        p = torch.clamp(swt / sw, 1.1920929e-07, 1 - 1.1920929e-07)
        base = -p * torch.log(p) - (1 - p) * torch.log(1 - p)
        return {"ctr": swt / sw, "cal": swp / swt, "ne": (sce / sw) / base}

    return rates(stats), rates(stats[-REC_WINDOW:])


def check_rec_leg(res, ref):
    """Counts exactly (the windows' lengths, Throughput's total), every
    value within rtol 1e-5 of the float64 references; the largest relative
    error by metric."""
    life, win = ref
    out = res["out"]
    got = {"ne": out["ne"], "ctr": out["ctr"], "cal": out["cal"],
           "wctr_lifetime": out["wctr"][0], "wctr_window": out["wctr"][1],
           "wcal_lifetime": out["wcal"][0], "wcal_window": out["wcal"][1]}
    want = {"ne": life["ne"], "ctr": life["ctr"], "cal": life["cal"],
            "wctr_lifetime": life["ctr"], "wctr_window": win["ctr"],
            "wcal_lifetime": life["cal"], "wcal_window": win["cal"]}
    errs = {}
    for k, g in got.items():
        g, w = g.double().cpu(), want[k].cpu()
        _require(g.shape == (REC_TASKS,) and bool(torch.isfinite(g).all()), f"rec leg {k}: {g.tolist()}")
        errs[k] = float(((g - w).abs() / w.abs()).max())
        _require(bool(torch.allclose(g, w, rtol=RTOL, atol=ATOL)),
                 f"rec leg {k} {g.tolist()} vs float64 {w.tolist()} (relative error {errs[k]:.3e})")
    _require(res["windows"] == [REC_WINDOW, REC_WINDOW], f"rec leg windows {res['windows']}")
    _require(res["num_total"] == res["preds"], f"Throughput counted {res['num_total']}")
    _require(abs(res["rate"] - res["preds"] / res["elapsed_s"]) <= 1e-6 * res["rate"],
             f"Throughput {res['rate']} vs rows over elapsed time")
    return errs


def r2_leg(dev):
    """``R2Score`` in its three ``multioutput`` modes, one collection, over
    4 batches of (2^22, 8) float32 regressors from a seed of their own;
    each value within rtol 1e-5 of float64 sums on the card."""
    from torcheval_tpu_torch.metrics import MetricCollection, R2Score

    g = torch.Generator(device=dev).manual_seed(SEED + 700)
    batches = []
    for _ in range(R2_BATCHES):
        y = torch.randn((R2_ROWS, R2_OUTPUTS), generator=g, device=dev) * 2 + 1
        batches.append((y + 0.6 * torch.randn((R2_ROWS, R2_OUTPUTS), generator=g, device=dev), y))
    col = MetricCollection({m: R2Score(multioutput=m, device=dev) for m in R2_MODES})
    torch.cuda.synchronize()
    folds0 = fold_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for yhat, y in batches:
        col.update(yhat, y)
    out = col.compute()
    end.record()
    end.synchronize()
    ss, s1, rss = (torch.zeros(R2_OUTPUTS, dtype=torch.float64, device=dev) for _ in range(3))
    for yhat, y in batches:
        yd = y.double()
        ss, s1, rss = ss + (yd * yd).sum(0), s1 + yd.sum(0), rss + ((yd - yhat.double()) ** 2).sum(0)
    n = R2_BATCHES * R2_ROWS
    tss = ss - s1 * s1 / n
    raw = 1 - rss / tss
    want = {"raw_values": raw, "uniform_average": raw.mean(),
            "variance_weighted": (raw * tss / tss.sum()).sum()}
    errs = {}
    for m in R2_MODES:
        got = out[m].double()
        errs[m] = float(((got - want[m]).abs() / want[m].abs()).max())
        _require(bool(torch.isfinite(got).all()) and bool(torch.allclose(got, want[m], rtol=RTOL, atol=ATOL)),
                 f"R2Score {m} {got.tolist()} vs float64 {want[m].tolist()} (relative error {errs[m]:.3e})")
    _require(all(int(col.metrics[m].num_obs) == n for m in R2_MODES), "R2Score counted every row")
    return {"errs": errs, "seconds": start.elapsed_time(end) / 1e3, "cadence": cadence(folds0),
            "uniform": float(out["uniform_average"])}


# ------------------------------------------ phase 4, ImageNet-val curve leg
def curve_leg_data(dev, gen):
    """The ImageNet-1k validation set's size: 5 batches of 10,000 rows of
    1000 softmax scores (float32) and int64 labels, made on the card."""
    return [
        (torch.softmax(torch.randn((CURVE_ROWS, CURVE_CLASSES), generator=gen, device=dev) * 3, dim=1),
         torch.randint(0, CURVE_CLASSES, (CURVE_ROWS,), generator=gen, device=dev))
        for _ in range(CURVE_BATCHES)
    ]


def curve_leg(dev, batches):
    """``MulticlassAUROC`` and ``MulticlassAUPRC`` (per class, compacting
    every 20,000 rows) and ``MulticlassBinnedPrecisionRecallCurve(1000,
    threshold=100)`` fed the same batches, from the first ``update()`` to the
    three ``compute()`` results. Also returns the flattened row count of
    each compaction."""
    import torcheval_tpu_torch.metrics.classification.auroc as auroc_mod
    from torcheval_tpu_torch.metrics import (
        MulticlassAUPRC,
        MulticlassAUROC,
        MulticlassBinnedPrecisionRecallCurve,
    )

    fold_rows = []
    compact_parts = auroc_mod._mc_compact_parts

    def counted(*args):
        fold_rows.append(args[7] * args[6])  # classes x padded rows
        return compact_parts(*args)

    auroc_mod._mc_compact_parts = counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        auroc = MulticlassAUROC(num_classes=CURVE_CLASSES, average=None,
                                compaction_threshold=CURVE_COMPACTION, device=dev)
        auprc = MulticlassAUPRC(num_classes=CURVE_CLASSES, average=None,
                                compaction_threshold=CURVE_COMPACTION, device=dev)
        binned = MulticlassBinnedPrecisionRecallCurve(CURVE_CLASSES, threshold=CURVE_THRESHOLDS, device=dev)
        for scores, labels in batches:
            auroc.update(scores, labels)
            auprc.update(scores, labels)
            binned.update(scores, labels)
        out = auroc.compute(), auprc.compute(), binned.compute()
        end.record()
        end.synchronize()
    finally:
        auroc_mod._mc_compact_parts = compact_parts
    peak = torch.cuda.max_memory_allocated(dev)
    return binned, out, start.elapsed_time(end) / 1e3, peak, fold_rows


def check_curve_leg(batches, binned, out):
    """AUROC and AUPRC per class within rtol 1e-5 of float64 numpy (the
    Mann-Whitney rank sum, and average precision over unique thresholds);
    the binned counts exactly against a numpy count from each class's
    sorted scores. Returns the largest relative error of each."""
    x = torch.cat([b[0] for b in batches]).cpu().numpy()
    t = torch.cat([b[1] for b in batches]).cpu().numpy()
    xt = np.ascontiguousarray(x.T)
    auroc, auprc, _ = (o.cpu().numpy() if isinstance(o, torch.Tensor) else o for o in out)
    thr = binned.threshold.cpu().numpy()
    sd = binned.state_dict()
    tp, fp, fn = (sd[k].cpu().numpy() for k in ("num_tp", "num_fp", "num_fn"))
    worst = {"auroc": 0.0, "auprc": 0.0}
    for c in range(CURVE_CLASSES):
        col = xt[c].astype(np.float64)
        pos = (t == c).astype(np.float64)
        for name, got, want in (("auroc", auroc[c], _mann_whitney_auc(col, pos)),
                                ("auprc", auprc[c], _average_precision(col, pos))):
            _require(np.isfinite(got) and _close(float(got), float(want)),
                     f"class {c} {name} {got} vs float64 {want}")
            worst[name] = max(worst[name], abs(float(got) - want) / abs(want))
        every, hits = np.sort(xt[c]), np.sort(xt[c][t == c])
        n_pred = every.size - np.searchsorted(every, thr, side="left")  # scores >= threshold
        n_tp = hits.size - np.searchsorted(hits, thr, side="left")
        _require(np.array_equal(tp[:, c], n_tp) and np.array_equal(fp[:, c], n_pred - n_tp)
                 and np.array_equal(fn[:, c], hits.size - n_tp), f"binned counts of class {c}")
    return worst


def check_exact_curve(batches):
    """``multiclass_precision_recall_curve`` on the first batch on the card,
    against the same function on the CPU (the plain route): equal lengths
    and thresholds, precision and recall within rtol 1e-5."""
    from torcheval_tpu_torch.metrics.functional import multiclass_precision_recall_curve

    scores, labels = batches[0]
    got = multiclass_precision_recall_curve(scores, labels)
    want = multiclass_precision_recall_curve(scores.cpu(), labels.cpu())
    points = 0
    for c in range(CURVE_CLASSES):
        gp, gr, gt = (g[c].cpu() for g in got)
        wp, wr, wt = (w[c] for w in want)
        _require(gt.shape == wt.shape and torch.equal(gt, wt), f"exact curve thresholds of class {c}")
        _require(torch.allclose(gp, wp, rtol=RTOL, atol=ATOL) and torch.allclose(gr, wr, rtol=RTOL, atol=ATOL),
                 f"exact curve of class {c}")
        points += gt.numel()
    return points


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


def _wire():
    """The toolkit's sync counters so far: rounds, payload bytes sent and
    the rounds' seconds (the ``toolkit.sync.round_seconds`` histograms)."""
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.utils.test_utils.obs_counts import count, parse_key

    snap = obs.snapshot()
    seconds = sum(h["sum"] for k, h in snap["histograms"].items()
                  if parse_key(k)[0] == "toolkit.sync.round_seconds")
    return {"rounds": int(count("toolkit.sync.rounds", snap)),
            "payload_bytes": int(count("toolkit.sync.payload_bytes", snap)), "seconds": seconds}


def _wire_since(mark):
    return {k: v - mark[k] for k, v in _wire().items()}


def _routes_since(counters0) -> dict:
    """``{"path/family": n}``: the curve metrics' routes counted
    (``ops.dist_curves.calls``) since the counters ``counters0``."""
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.utils.test_utils.obs_counts import parse_key

    out = {}
    for key, n in obs.snapshot()["counters"].items():
        name, labels = parse_key(key)
        if name == "ops.dist_curves.calls" and n != counters0.get(key, 0.0):
            out[f"{labels['path']}/{labels['family']}"] = int(n - counters0.get(key, 0.0))
    return out


def dp_worker(rank: int, port: str) -> int:
    """One rank of the data-parallel leg (``chip_smoke.py --dp-rank R
    PORT``): its block of the chunks through two ``ShardedEvaluator``s on
    ``cuda:0``, synced over gloo; prints one ``DP_RESULT`` JSON line."""
    import torch.distributed as dist

    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.metrics import BinaryAUROC, MulticlassAccuracy, MulticlassF1Score
    from torcheval_tpu_torch.metrics import toolkit
    from torcheval_tpu_torch.ops import stream_compact as stream_compact_module
    from torcheval_tpu_torch.parallel import (
        ShardedEvaluator,
        data_parallel_mesh,
        init_from_env,
        shutdown,
    )

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(DP_RANKS),
                      RANK=str(rank), LOCAL_RANK="0")
    obs.enable()  # every count this rank reports is the registry's
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
    K.hist = 0
    K.stream_compact = 0
    wire0 = _wire()
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
        "hist_launches": K.hist,
        "stream_compact_launches": K.stream_compact,
        "fold_rows": fold_rows,
        **{f"sync_{k}": v for k, v in _wire_since(wire0).items()},
        "cadence": cadence(folds0),
    }
    # the synced counts, for the exact check (two more small syncs)
    for name in ("accuracy", "f1_macro"):
        sd = toolkit.get_synced_state_dict(classification.metrics[name], recipient_rank="all")
        out[f"{name}_counts"] = {k: v.cpu().tolist() for k, v in sd.items()}
    out["obs"] = dp_obs_snapshot(rank)
    shutdown()
    print("DP_RESULT " + json.dumps(out), flush=True)
    return 0


def check_dp_obs(ranks) -> dict:
    """The obs phase's part (d) gates over both ranks' ``DP_RESULT``s."""
    summed = defaultdict(float)
    for res in ranks:
        for k, v in res["obs"]["local_counters"].items():
            summed[k] += v
    for res in ranks:
        o, r = res["obs"], res["rank"]
        _require(o["extra_rounds"] == 1, f"(d) rank {r}: sync_snapshot took {o['extra_rounds']} rounds")
        _require(o["world"] == DP_RANKS and o["ranks"] == list(range(DP_RANKS)) and not o["degraded"]
                 and not o["truncated_ranks"], f"(d) rank {r}: a whole view {o['ranks']}")
        _require(o["merged_counters"] == dict(summed),
                 f"(d) rank {r}: merged counters equal the sum of the ranks' local snapshots")
        _require(o["merged_gauges"] and all("rank=" in g for g in o["merged_gauges"]),
                 f"(d) rank {r}: every merged gauge carries rank=")
    o = ranks[0]["obs"]
    _require(o["metrics_equal"] and o["metrics_type"].startswith("text/plain"),
             "(d) GET /metrics answers prometheus_text()'s bytes")
    _require(o["health"] == {"ok": True}, f"(d) GET /health answers {o['health']}")
    return o


def dp_obs_snapshot(rank: int) -> dict:
    """The obs phase's part (d), on a data-parallel rank after its synced
    computes: ``obs.sync_snapshot(timeout_s=30)`` merges both ranks'
    registries in one round; rank 0 also serves ``GET /metrics`` and
    ``GET /health`` from a ``MetricsServer`` on an ephemeral port."""
    import urllib.request

    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.utils.test_utils.obs_counts import count, rounds

    local = obs.snapshot()
    r0, b0 = rounds(), count("toolkit.sync.payload_bytes")
    t0 = time.perf_counter()
    merged = obs.sync_snapshot(timeout_s=30)
    res = {"seconds": time.perf_counter() - t0, "extra_rounds": rounds() - r0,
           "buffer_bytes": int(count("toolkit.sync.payload_bytes") - b0),
           "local_counters": local["counters"], "merged_counters": merged["counters"],
           "merged_gauges": sorted(merged["gauges"]), "world": merged["world_size"],
           "ranks": merged["ranks"], "degraded": merged["degraded"],
           "truncated_ranks": merged["truncated_ranks"], "merged_events": len(merged["events"])}
    if rank == 0:
        srv = obs.MetricsServer(port=0).start()
        try:
            base = f"http://127.0.0.1:{srv.port}"
            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                body, ctype = r.read(), r.headers.get("Content-Type", "")
            text = obs.prometheus_text().encode()
            with urllib.request.urlopen(base + "/health", timeout=30) as r:
                health = json.loads(r.read())
        finally:
            srv.close()
        res["metrics_equal"] = body == text
        res["metrics_bytes"] = len(body)
        res["metrics_type"] = ctype
        res["health"] = health
    return res


def run_ranks(flag, ranks, timeout_s, extra=(), env_extra=None, expect=None):
    """Spawn ``chip_smoke.py <flag> R PORT *extra`` for each rank R, wait
    for them (killing all at the time limit) and return each rank's
    standard output. ``env_extra`` is added to the ranks' environment, from
    which the parent's ``TORCHEVAL_TPU_CHAOS*`` are dropped; ``expect[r]``
    is rank r's exit code (0 for every rank by default), and any other
    exit fails the leg."""
    port = str(_free_port())
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
           and not k.startswith("TORCHEVAL_TPU_CHAOS")}
    env.update(env_extra or {})
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(r), port, *extra],
                         cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(ranks)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        want = 0 if expect is None else expect[r]
        if p.returncode != want:
            print(err[-6000:], file=sys.stderr)
            raise RuntimeError(f"check failed: {flag} {' '.join(extra)} rank {r} exited "
                               f"{p.returncode}, expected {want}")
    return [out for out, _ in outs]


def tagged_lines(out, prefix):
    """``{tag: [objects]}`` of the ``<tag> {json}`` lines whose tag starts
    with ``prefix``."""
    tagged = {}
    for ln in out.splitlines():
        tag, _, rest = ln.partition(" ")
        if tag.startswith(prefix):
            tagged.setdefault(tag, []).append(json.loads(rest))
    return tagged


def spawn_ranks(flag, ranks, tag, timeout_s, *extra):
    """``run_ranks`` where every rank exits 0 and prints one ``<tag> {json}``
    line: each rank's object."""
    results = []
    for r, out in enumerate(run_ranks(flag, ranks, timeout_s, extra)):
        lines = tagged_lines(out, tag).get(tag, [])
        _require(len(lines) == 1, f"{flag} rank {r} printed its result")
        results.append(lines[0])
    return results


def dp_leg():
    """The data-parallel ranks' results."""
    return spawn_ranks("--dp-rank", DP_RANKS, "DP_RESULT", DP_TIMEOUT_S)


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


# ---------------------------------------------------- phase 4, sharded leg
def _collectives():
    """The gloo bytes this rank has sent so far, and the collective count."""
    from torcheval_tpu_torch.utils import dist as tdist

    return (tdist.all_gather_stacked.bytes + tdist.all_reduce_sum.bytes,
            tdist.all_gather_stacked.calls + tdist.all_reduce_sum.calls)


def _since(mark):
    now = _collectives()
    return {"collective_bytes": now[0] - mark[0], "collectives": now[1] - mark[1]}


def shard_worker(rank: int, port: str, outdir: str) -> int:
    """One rank of the sharded leg (``chip_smoke.py --shard-rank R PORT
    OUTDIR``), on ``cuda:0`` over gloo: the retrieval leg's batches with the
    label axis split over the ranks (``NDCG(label_mesh=)``), the row-sharded
    top-k over each rank's rows of them, bench's ``config11_sliced`` with
    the cohorts split over the ranks (``SlicedMetricCollection(mesh=,
    mesh_axis=)``), and the sharded segment sum over each rank's half of the
    sliced window. Every path's launches and collective bytes are counted
    from zero around it; the checks' launches are not. Prints one
    ``SHARD_RESULT`` JSON line and writes its per-cohort values to
    ``OUTDIR/rank<R>_sliced.npz``."""
    from types import SimpleNamespace

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.metrics import NDCG
    from torcheval_tpu_torch.ops.scatter import segment_sum_plain, sharded_segment_sum
    from torcheval_tpu_torch.ops.topk import sharded_label_topk, sharded_topk_kernel, topk_kernel
    from torcheval_tpu_torch.parallel import (
        block_bounds,
        data_parallel_mesh,
        init_from_env,
        label_tile,
        shard_batch,
        shutdown,
    )

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(SHARD_RANKS),
                      RANK=str(rank), LOCAL_RANK="0")
    obs.enable()  # every count this rank reports is the registry's
    _require(init_from_env(backend="gloo") == (rank, SHARD_RANKS), "sharded rank joined")
    dev = torch.device("cuda", 0)
    label_mesh = init_device_mesh("cuda", (SHARD_RANKS,), mesh_dim_names=("label",))
    slice_mesh = init_device_mesh("cuda", (SHARD_RANKS,), mesh_dim_names=("slice",))
    out = {"rank": rank, "retrieval": {}}

    # --- the retrieval leg's batches, each rank keeping its label tile (and
    # its block of rows for the row-sharded top-k), with the one-process
    # top-k of every batch to hold the merged indices against
    batches = retrieval_leg_data(dev)
    want = {k: [topk_kernel(s, k)[1] for s, _ in batches] for k in RETRIEVAL_KS}
    blocks = [shard_batch(data_parallel_mesh(), s) for s, _ in batches]
    tiles = [(label_tile(s, label_mesh, "label"), label_tile(t, label_mesh, "label"))
             for s, t in batches]
    del batches
    torch.cuda.empty_cache()
    _require(all(ts.shape == (RETRIEVAL_ROWS, SHARD_LABELS) for ts, _ in tiles), "label tiles")
    lm = (label_mesh, "label")
    NDCG(k=RETRIEVAL_KS[0], label_mesh=lm, device=dev).update(*tiles[0]).compute()  # warm-up
    torch.cuda.synchronize()
    dist.barrier()
    for k in RETRIEVAL_KS:
        K.topk_kernel = 0
        mark = _collectives()
        folds0 = fold_counts()
        t0 = time.perf_counter()
        ndcg = NDCG(k=k, label_mesh=lm, device=dev)
        for ts, tt in tiles:
            ndcg.update(ts, tt)
        value = float(ndcg.compute())
        seconds = time.perf_counter() - t0
        out["retrieval"][str(k)] = {"value": value, "num_valid": int(ndcg.num_valid),
                                    "seconds": seconds, "topk_launches": K.topk_kernel,
                                    "cadence": cadence(folds0), **_since(mark)}
    for k in RETRIEVAL_KS:
        for b, (ts, _) in enumerate(tiles):
            _, idx = sharded_label_topk(ts, k, mesh=label_mesh, label_axis="label")
            _require(torch.equal(idx, want[k][b]),
                     f"rank {rank}: merged top-{k} indices of batch {b} equal the one-process top-k")
    # --- the row-sharded top-k: this rank's rows of each batch, no collective
    lo, hi = block_bounds(RETRIEVAL_ROWS, SHARD_RANKS, rank)
    K.topk_kernel = 0
    mark = _collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [sharded_topk_kernel(blk, RETRIEVAL_KS[-1])[1] for blk in blocks]
    torch.cuda.synchronize()
    out["row_topk"] = {"seconds": time.perf_counter() - t0, "topk_launches": K.topk_kernel,
                       **_since(mark)}
    for b, idx in enumerate(got):
        _require(torch.equal(idx, want[RETRIEVAL_KS[-1]][b][lo:hi]),
                 f"rank {rank}: row-sharded top-k of batch {b} equals the one-process rows")
    del tiles, blocks, want, got
    torch.cuda.empty_cache()

    # --- config11 with the cohorts split over the ranks
    data = sliced_leg_data(dev)
    mesh_kw = {"mesh": slice_mesh, "mesh_axis": "slice"}
    sliced_epoch(dev, data, *sliced_setup(dev, data, **mesh_kw))  # warm-up
    acc, agg = sliced_setup(dev, data, **mesh_kw)
    dist.barrier()
    K.segment_sum = 0
    mark = _collectives()
    folds0 = fold_counts()
    with record_sketch_folds() as rec:
        results, sliced_s, sliced_wall, sliced_peak = sliced_epoch(dev, data, acc, agg)
    out["sliced"] = {"seconds": sliced_s, "wall_seconds": sliced_wall, "peak_bytes": sliced_peak,
                     "segment_sum_launches": K.segment_sum, "cadence": cadence(folds0),
                     "sketch_folds": rec.count(n=SLICED_BATCHES * SLICED_ROWS,
                                               segments=SHARD_COHORTS * SLICED_PLANES),
                     **_since(mark)}
    for col in (acc, agg):
        for m in col.metrics.values():
            rows = getattr(m, m._sliced_state_names[0]).shape[0]
            _require(rows == SHARD_COHORTS, f"rank {rank}: a member holds {rows} cohort rows")
    # the checks read the states in the unsharded layout (a gather each)
    acc_state = SimpleNamespace(**acc.metrics["acc"].state_dict())
    auroc_state = SimpleNamespace(**acc.metrics["auroc"].state_dict())
    worst_mean = check_sliced_leg(data, acc_state, results)
    trap_err, mw_err, mw_bound, occupied = check_sliced_sketch(data, auroc_state, results)
    out["sliced"].update(worst_mean=worst_mean, trap_err=trap_err, mw_err=mw_err,
                         mw_bound=mw_bound, occupied=occupied)
    np.savez(os.path.join(outdir, f"rank{rank}_sliced.npz"), ids=results["acc"].slice_ids,
             **{k: results[k]["values"].cpu().numpy() for k in ("acc", "auroc", "mean", "max")})

    # --- the sharded segment sum: each rank sums its half of the sliced
    # window's accuracy deltas, then one all_reduce
    window = slice(SLICED_ROWS, (SLICED_BATCHES + 1) * SLICED_ROWS)
    rows = torch.from_numpy(acc.slice_table.lookup_rows(data[0][window])).to(dev)
    correct = ((data[1][window] >= 0.5).to(torch.float32) == data[2][window]).to(torch.int32)
    deltas = torch.stack([correct, torch.ones_like(correct)], dim=-1)
    lo, hi = block_bounds(rows.shape[0], SHARD_RANKS, rank)
    K.segment_sum = 0
    mark = _collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total = sharded_segment_sum(deltas[lo:hi], rows[lo:hi], SLICED_COHORTS)
    torch.cuda.synchronize()
    out["sharded_segment_sum"] = {"seconds": time.perf_counter() - t0,
                                  "segment_sum_launches": K.segment_sum, **_since(mark)}
    _require(torch.equal(total, segment_sum_plain(deltas, rows, SLICED_COHORTS)),
             f"rank {rank}: sharded segment sum equals the plain sum of the whole window")
    shutdown()
    print("SHARD_RESULT " + json.dumps(out), flush=True)
    return 0


def shard_leg(outdir):
    """The sharded leg's ranks' results."""
    return spawn_ranks("--shard-rank", SHARD_RANKS, "SHARD_RESULT", SHARD_TIMEOUT_S, outdir)


def check_shard_leg(ranks, outdir, retrieval, sliced, sliced_launches):
    """Each rank against the one-process legs: NDCG within rtol 1e-5 and
    the same valid rows; every cohort's id, accuracy, AUROC and max equal,
    its mean within rtol 1e-5; the launches of each path."""
    for res in ranks:
        r = res["rank"]
        for k in RETRIEVAL_KS:
            got = res["retrieval"][str(k)]
            value, num_valid = retrieval[k]
            _require(got["num_valid"] == num_valid and _close(got["value"], value),
                     f"rank {r}: label-sharded NDCG@{k} {got['value']} vs one process {value}")
            _require(got["topk_launches"] == 2 * RETRIEVAL_BATCHES,
                     f"rank {r}: NDCG@{k} launched topk {got['topk_launches']} times (ranking and "
                     "ideal a batch)")
        _require(res["row_topk"]["topk_launches"] == RETRIEVAL_BATCHES
                 and res["row_topk"]["collectives"] == 0,
                 f"rank {r}: the row-sharded top-k launched once a batch, no collective")
        _require(res["sliced"]["segment_sum_launches"] == sliced_launches
                 and res["sliced"]["sketch_folds"] == 1,
                 f"rank {r}: sliced segment_sum launches {res['sliced']['segment_sum_launches']} "
                 f"vs the one-process leg's {sliced_launches}, one sketch fold on the tile")
        _require(res["sharded_segment_sum"]["segment_sum_launches"] == 1
                 and res["sharded_segment_sum"]["collectives"] == 1,
                 f"rank {r}: sharded segment sum, one launch and one all_reduce")
        with np.load(os.path.join(outdir, f"rank{r}_sliced.npz")) as f:
            _require(np.array_equal(f["ids"], sliced["ids"]), f"rank {r}: cohort ids")
            for key in ("acc", "auroc", "max"):
                _require(np.array_equal(f[key], sliced[key]), f"rank {r}: per-cohort {key} equal")
            err = np.abs(f["mean"].astype(np.float64) - sliced["mean"])
            _require(bool(np.all(err <= ATOL + RTOL * np.abs(sliced["mean"]))),
                     f"rank {r}: per-cohort mean (largest error {err.max():.3e})")


# ------------------------------------------- phase 4, distributed-curves leg
def dist_curve_batches(dev):
    """The ImageNet-val curve leg's shapes from a seed of their own (the
    parent and both ranks make the same batches): 5 x (10,000, 1000)
    softmax scores and int64 labels."""
    return curve_leg_data(dev, torch.Generator(device=dev).manual_seed(SEED + 300))


def dist_small_batch(dev, kind):
    """Part (d)'s batches: ``ties`` (80% of the scores on one value) or
    ``nan`` (uniform scores, a few NaN), ``DIST_SMALL_ROWS`` rows."""
    g = torch.Generator(device=dev).manual_seed(SEED + 400 + (kind == "nan"))
    s = torch.rand((DIST_SMALL_ROWS,), generator=g, device=dev)
    t = (torch.rand((DIST_SMALL_ROWS,), generator=g, device=dev) < 0.4).to(torch.float32)
    if kind == "ties":
        s = torch.where(s < 0.8, torch.full_like(s, 0.5), s)
    else:
        s[:: DIST_SMALL_ROWS // 8] = float("nan")
    return s, t


def _dist_collectives():
    """``(calls, bytes)`` of the three collectives of ``utils/dist.py``."""
    from torcheval_tpu_torch.utils import dist as tdist

    fns = (tdist.all_reduce_sum, tdist.all_gather_stacked, tdist.all_to_all_rows)
    return {f.__name__: (f.calls, f.bytes) for f in fns}


def _dist_since(mark):
    now = _dist_collectives()
    return {k: [now[k][0] - mark[k][0], now[k][1] - mark[k][1]] for k in now}


def dist_worker(rank: int, port: str, outdir: str) -> int:
    """One rank of the distributed-curves leg (``chip_smoke.py --dist-rank R
    PORT OUTDIR``), on ``cuda:0`` over gloo, every part through a
    ``ShardedEvaluator`` over the two ranks: (a) ``BinaryAUROC`` and
    ``BinaryAUPRC`` over its 4 data-parallel chunks (a raw cache of 2^26
    rows); (b) ``MulticlassAUROC``/``MulticlassAUPRC`` (1000 classes, per
    class) over its 3 or 2 ImageNet-val batches; (c) ``BinaryAUROC(approx=
    True)`` over (a)'s chunks; (d) a batch of massive ties at a bucket
    capacity factor of 1 (at two ranks the factor 4 holds every row) and a
    batch with NaN scores. Each part's kernel launches, collectives and
    route counter are counted from zero around its updates and compute; the
    gather route (the toolkit's sync of the same members) is timed after it
    for comparison. Prints one ``DIST_RESULT`` JSON line and writes (c)'s
    global sketch counts to ``OUTDIR/rank<R>_sketch.npz``."""
    import torch.distributed as dist

    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.utils.test_utils.obs_counts import count
    from torcheval_tpu_torch.metrics import (
        BinaryAUPRC,
        BinaryAUROC,
        MulticlassAUPRC,
        MulticlassAUROC,
        toolkit,
    )
    from torcheval_tpu_torch.ops import dist_curves as dc
    from torcheval_tpu_torch.parallel import ShardedEvaluator, data_parallel_mesh, init_from_env, shutdown

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(DIST_RANKS),
                      RANK=str(rank), LOCAL_RANK="0")
    obs.enable()  # every count this rank reports is the registry's
    _require(init_from_env(backend="gloo") == (rank, DIST_RANKS), "distributed-curves rank joined")
    mesh = data_parallel_mesh()
    dev = mesh.device
    # where a distributed call's host seconds go: each collective of
    # ops/dist_curves.py timed between two synchronisations (the exchange
    # with its host staging); the rest is the rank's own device work. The
    # largest all-reduce of a part is its splitter histogram's.
    spent, reduces = {}, []

    def timed(name, fn):
        def run(t, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(t, *args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            spent[name] = spent.get(name, 0.0) + dt
            if name == "all_reduce":
                reduces.append((t.numel() * t.element_size(), dt))
            return out

        return run

    dc._all_reduce = timed("all_reduce", dc._all_reduce)
    dc._all_gather = timed("all_gather", dc._all_gather)
    dc.exchange_buckets = timed("exchange", dc.exchange_buckets)
    lossy, splitters = dc.lossy_splitter_sum, []

    def lossy_timed(local, mode, pg, k):
        """The quantized splitter round: its seconds (between two
        synchronisations) and the bytes that entered its collectives."""
        torch.cuda.synchronize()
        mark, t0 = _dist_collectives(), time.perf_counter()
        out = lossy(local, mode, pg, k)
        torch.cuda.synchronize()
        splitters.append((sum(v[1] for v in _dist_since(mark).values()), time.perf_counter() - t0))
        return out

    dc.lossy_splitter_sum = lossy_timed

    def drive(members, batches, gather=True, before_compute=None):
        """Updates and ``compute()`` through the evaluator, counted from
        zero; then, for comparison, the gather route on clones."""
        ev = ShardedEvaluator(members, mesh=mesh)
        torch.cuda.synchronize()
        dist.barrier()
        K.hist = K.segment_sum = K.stream_compact = 0
        counters0 = obs.snapshot()["counters"]
        wire0, mark = _wire(), _dist_collectives()
        reduces.clear()
        splitters.clear()
        spent.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for b in batches:
            ev.update(*b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = ev.compute()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res = {
            "values": {k: v.double().reshape(-1).cpu().tolist() for k, v in out.items()},
            "update_seconds": t1 - t0, "compute_seconds": t2 - t1,
            "routes": _routes_since(counters0),
            "gather_rounds": _wire_since(wire0)["rounds"], "collectives": _dist_since(mark),
            "exchange_send_bytes": int(count("dist_curves.exchange_send_bytes")
                                       - count("dist_curves.exchange_send_bytes", {"counters": counters0})),
            "launches": {"hist": K.hist, "segment_sum": K.segment_sum,
                         "stream_compact": K.stream_compact},
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "largest_all_reduce": max(reduces) if reduces else None,
            "splitter_rounds": list(splitters) if splitters else None,
            "collective_seconds": dict(spent),
        }
        if gather:
            clones = {k: toolkit.clone_metric(m) for k, m in ev.metrics.items()}
            wire0, mark = _wire(), _dist_collectives()
            dist.barrier()
            t0 = time.perf_counter()
            got = toolkit.sync_and_compute_collection(clones, recipient_rank="all")
            torch.cuda.synchronize()
            res["gather"] = {
                "compute_seconds": time.perf_counter() - t0, "rounds": _wire_since(wire0)["rounds"],
                "collectives": _dist_since(mark),
                "values": {k: v.double().reshape(-1).cpu().tolist() for k, v in got.items()},
            }
        return ev, res

    out = {"rank": rank}
    # warm-up (untimed): each route once at a small size
    small = [(torch.rand(1 << 16, device=dev), (torch.rand(1 << 16, device=dev) < 0.5).float())]
    drive({"a": BinaryAUROC(device=dev), "b": BinaryAUROC(approx=True, device=dev)}, small, gather=False)
    drive({"m": MulticlassAUROC(num_classes=8, device=dev)},
          [(torch.rand((4096, 8), device=dev), torch.randint(0, 8, (4096,), device=dev))], gather=False)

    per = DP_CHUNKS // DIST_RANKS
    chunks = [dp_chunk(dev, i)[2:] for i in range(rank * per, (rank + 1) * per)]
    _, out["binary"] = drive({"auroc": BinaryAUROC(device=dev), "auprc": BinaryAUPRC(device=dev)},
                             chunks)
    # (e) the quantized routes of (a), the mode set through the environment
    # as a user's evaluator would read it
    out["quantized"] = {}
    for mode in QUANT_MODES:
        os.environ["TORCHEVAL_TPU_SYNC_QUANTIZE"] = mode
        _, out["quantized"][f"binary/{mode}"] = drive(
            {"auroc": BinaryAUROC(device=dev), "auprc": BinaryAUPRC(device=dev)}, chunks, gather=False)
    os.environ.pop("TORCHEVAL_TPU_SYNC_QUANTIZE")
    ev, out["approx"] = drive({"auroc": BinaryAUROC(approx=True, device=dev)}, chunks)
    m = ev.metrics["auroc"]
    empty_s, empty_t = m._empty_block()
    sketch_args = (list(m.inputs) or [empty_s], list(m.targets) or [empty_t])
    sketch_kw = dict(bucket_bits=m._sketch_bits, base=(m.sketch_tp, m.sketch_fp, m.sketch_nan_dropped))
    tp, fp, nan = dc.sharded_sketch_counts(*sketch_args, **sketch_kw)
    np.savez(os.path.join(outdir, f"rank{rank}_sketch.npz"), tp=tp.cpu().numpy(),
             fp=fp.cpu().numpy(), nan=nan.cpu().numpy())
    # (e) the sketch all-reduce is never quantized
    os.environ["TORCHEVAL_TPU_SYNC_QUANTIZE"] = "int8"
    q_counts = dc.sharded_sketch_counts(*sketch_args, **sketch_kw)
    os.environ.pop("TORCHEVAL_TPU_SYNC_QUANTIZE")
    out["quantized"]["sketch_equal"] = all(torch.equal(a, b) for a, b in zip(q_counts, (tp, fp, nan)))
    del chunks, ev, m, sketch_args, sketch_kw, q_counts
    torch.cuda.empty_cache()

    lo = sum(DIST_CURVE_SPLIT[:rank])
    batches = dist_curve_batches(dev)[lo : lo + DIST_CURVE_SPLIT[rank]]
    _, out["multiclass"] = drive(
        {"auroc": MulticlassAUROC(num_classes=CURVE_CLASSES, average=None, device=dev),
         "auprc": MulticlassAUPRC(num_classes=CURVE_CLASSES, average=None, device=dev)}, batches)
    for mode in QUANT_MODES:  # (e) the quantized routes of (b)
        os.environ["TORCHEVAL_TPU_SYNC_QUANTIZE"] = mode
        _, out["quantized"][f"multiclass/{mode}"] = drive(
            {"auroc": MulticlassAUROC(num_classes=CURVE_CLASSES, average=None, device=dev),
             "auprc": MulticlassAUPRC(num_classes=CURVE_CLASSES, average=None, device=dev)},
            batches, gather=False)
    os.environ.pop("TORCHEVAL_TPU_SYNC_QUANTIZE")
    del batches
    torch.cuda.empty_cache()

    out["fallback"] = {}
    for kind in ("ties", "nan"):
        s, t = dist_small_batch(dev, kind)
        lo, hi = rank * DIST_SMALL_ROWS // DIST_RANKS, (rank + 1) * DIST_SMALL_ROWS // DIST_RANKS
        dc.DIST_CAPACITY_FACTOR = 1 if kind == "ties" else 4
        _, out["fallback"][kind] = drive({"auroc": BinaryAUROC(device=dev),
                                          "auprc": BinaryAUPRC(device=dev)}, [(s[lo:hi], t[lo:hi])],
                                         gather=False)
    dc.DIST_CAPACITY_FACTOR = 4
    # (e) NaN scores still trip the error channel on a quantized route
    s, t = dist_small_batch(dev, "nan")
    lo, hi = rank * DIST_SMALL_ROWS // DIST_RANKS, (rank + 1) * DIST_SMALL_ROWS // DIST_RANKS
    os.environ["TORCHEVAL_TPU_SYNC_QUANTIZE"] = "int8"
    _, out["quantized"]["nan/int8"] = drive({"auroc": BinaryAUROC(device=dev),
                                             "auprc": BinaryAUPRC(device=dev)},
                                            [(s[lo:hi], t[lo:hi])], gather=False)
    os.environ.pop("TORCHEVAL_TPU_SYNC_QUANTIZE")
    out["quantized"]["bit_equal"] = dist_quantized_scores(dev, rank, dc)
    out["sync"] = quantized_sync(dev, rank, outdir, toolkit)
    shutdown()
    print("DIST_RESULT " + json.dumps(out), flush=True)
    return 0


def dist_quantized_scores(dev, rank, dc):
    """(e) A small case of quantized scores (300 levels; 2^16 rows a rank,
    and (2^14, 50) for the multiclass pair): for each quantized route,
    whether its values are bit-identical to the raw route's and their
    largest relative difference; the error rows must be 0 on both."""
    g = torch.Generator(device=dev).manual_seed(SEED + 800 + rank)
    s = torch.randint(0, 300, (1 << 16,), generator=g, device=dev).to(torch.float32) / 300
    t = (torch.rand((1 << 16,), generator=g, device=dev) < 0.4).to(torch.float32)
    x = torch.randint(0, 300, (1 << 14, 50), generator=g, device=dev).to(torch.float32) / 300
    y = torch.randint(0, 50, (1 << 14,), generator=g, device=dev)
    out = {}
    for name, fn, args in (("auroc", dc.sharded_binary_auroc, ([s], [t])),
                           ("auprc", dc.sharded_binary_auprc, ([s], [t])),
                           ("mc_auroc", dc.sharded_multiclass_auroc, ([x], [y])),
                           ("mc_auprc", dc.sharded_multiclass_auprc, ([x], [y]))):
        raw, raw_err = fn(*args, quantize=False)
        for mode in QUANT_MODES:
            got, err = fn(*args, quantize=mode)
            _require(err == raw_err == 0, f"(e) quantized scores {name}/{mode}: error rows {err}")
            rel = float(((got.double() - raw.double()).abs() / raw.double().abs()).max())
            out[f"{name}/{mode}"] = [bool(torch.equal(got, raw)), rel]
    return out


def quantized_sync(dev, rank, outdir, toolkit):
    """The quantized sync: ``sync_and_compute_collection`` over the two
    ranks of config 3's ``MulticlassConfusionMatrix(1000)`` (this rank's
    share of its 13 batches, from a seed of their own: the narrow lane), a
    ``BinaryAUROC(approx=True)`` sketch over one data-parallel chunk (the
    bucket lane) and a ``WeightedCalibration(num_tasks=256)`` (the q8 lane),
    with ``quantize=False`` and then ``True``. Records each round's payload
    bytes and seconds, the results, and (to ``OUTDIR/rank<R>_cal.npz``) the
    calibration's local and synced sums for the parent's bound."""
    from torcheval_tpu_torch.metrics import BinaryAUROC, MulticlassConfusionMatrix, WeightedCalibration

    batches = cm_leg_data(dev, torch.Generator(device=dev).manual_seed(SEED + 500))[rank::DIST_RANKS]
    _, _, logits, binary = dp_chunk(dev, rank)
    g = torch.Generator(device=dev).manual_seed(SEED + 900 + rank)
    shape = (SYNC_CAL_TASKS, 1 << 14)
    p = torch.rand(shape, generator=g, device=dev)
    clicks = (torch.rand(shape, generator=g, device=dev) < 0.1).to(torch.float32)
    w = torch.rand(shape, generator=g, device=dev) + 0.5
    inner, rounds_log = toolkit._allgather_stacked, []

    def logged(x, group, round_label="collective", lane="typed"):
        t0 = time.perf_counter()
        got = inner(x, group, round_label, lane)
        rounds_log.append((round_label, x.numel() * x.element_size(), time.perf_counter() - t0))
        return got

    toolkit._allgather_stacked = logged
    res, local = {}, {}
    try:
        for quantize in (False, True):
            cm = MulticlassConfusionMatrix(CM_CLASSES, device=dev)
            for pred, label in batches:
                cm.update(pred, label)
            sketch = BinaryAUROC(approx=True, device=dev).update(logits, binary)
            sketch._compact()  # the resident sketch alone crosses the wire
            cal = WeightedCalibration(num_tasks=SYNC_CAL_TASKS, device=dev).update(p, clicks, w)
            members = {"cm": cm, "sketch": sketch, "cal": cal}
            local = {k: v.cpu().numpy() for k, v in cal.state_dict().items()}
            rounds_log.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = toolkit.sync_and_compute_collection(members, recipient_rank="all", quantize=quantize)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rounds = [list(r) for r in rounds_log]
            synced = toolkit.get_synced_metric(cal, recipient_rank="all", quantize=quantize)
            np.savez(os.path.join(outdir, f"rank{rank}_cal_{quantize}.npz"),
                     **{f"synced_{k}": v.cpu().numpy() for k, v in synced.state_dict().items()},
                     **{f"local_{k}": v for k, v in local.items()})
            res[str(quantize)] = {
                "cm_sha": hash_bytes(out["cm"]), "cm_dtype": str(out["cm"].dtype).removeprefix("torch."),
                "cm_total": int(out["cm"].sum()), "sketch_auroc": float(out["sketch"]),
                "rounds": rounds, "seconds": seconds,
            }
    finally:
        toolkit._allgather_stacked = inner
    return res


def hash_bytes(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def dist_leg(outdir):
    """The distributed-curves ranks' results."""
    return spawn_ranks("--dist-rank", DIST_RANKS, "DIST_RESULT", DIST_TIMEOUT_S, outdir)


def dist_references(dev):
    """One process, without the distributed route: ``BinaryAUPRC`` and
    ``BinaryAUROC(approx=True)`` over the 8 data-parallel chunks (the
    uncompacted AUROC is ``dp_reference``'s), per-class ``MulticlassAUROC``
    and ``MulticlassAUPRC`` over the 5 curve batches, and both metrics on
    part (d)'s two batches."""
    from torcheval_tpu_torch.metrics import BinaryAUPRC, BinaryAUROC, MulticlassAUPRC, MulticlassAUROC

    auprc, approx = BinaryAUPRC(device=dev), BinaryAUROC(approx=True, device=dev)
    for i in range(DP_CHUNKS):
        _, _, logits, binary = dp_chunk(dev, i)
        auprc.update(logits, binary)
        approx.update(logits, binary)
    ref = {"auprc": float(auprc.compute()), "approx_auroc": float(approx.compute())}
    approx._compact()  # fold any staged rows into the resident sketch
    ref["sketch"] = {k: v.cpu().numpy() for k, v in (
        ("tp", approx.sketch_tp), ("fp", approx.sketch_fp), ("nan", approx.sketch_nan_dropped))}
    del auprc, approx
    mc = {"auroc": MulticlassAUROC(num_classes=CURVE_CLASSES, average=None, device=dev),
          "auprc": MulticlassAUPRC(num_classes=CURVE_CLASSES, average=None, device=dev)}
    for x, y in dist_curve_batches(dev):
        for m in mc.values():
            m.update(x, y)
    ref["multiclass"] = {k: m.compute().double().cpu().numpy() for k, m in mc.items()}
    ref["fallback"] = {}
    for kind in ("ties", "nan"):
        s, t = dist_small_batch(dev, kind)
        ref["fallback"][kind] = {"auroc": float(BinaryAUROC(device=dev).update(s, t).compute()),
                                 "auprc": float(BinaryAUPRC(device=dev).update(s, t).compute())}
    return ref


def check_dist_leg(ranks, outdir, auroc_ref, ref):
    """Gates (a)-(d) on every rank: values against the one-process ones
    (rtol 1e-5), the sketch counts exactly, the routes, no gather round on
    the distributed route, and the kernels launched on it."""
    for res in ranks:
        r = res["rank"]
        a = res["binary"]
        _require(_close(a["values"]["auroc"][0], auroc_ref),
                 f"rank {r} (a): dist AUROC {a['values']['auroc'][0]} vs one process {auroc_ref}")
        _require(_close(a["values"]["auprc"][0], ref["auprc"]),
                 f"rank {r} (a): dist AUPRC {a['values']['auprc'][0]} vs one process {ref['auprc']}")
        _require(a["routes"] == {"dist/binary": 2} and a["gather_rounds"] == 0,
                 f"rank {r} (a): routes {a['routes']}, gather rounds {a['gather_rounds']}")
        _require(a["launches"]["hist"] == 2, f"rank {r} (a): hist launches {a['launches']}")
        b = res["multiclass"]
        for k in ("auroc", "auprc"):
            got, want = np.asarray(b["values"][k]), ref["multiclass"][k]
            err = np.abs(got - want)
            _require(got.shape == want.shape and bool(np.all(err <= ATOL + RTOL * np.abs(want))),
                     f"rank {r} (b): per-class {k} (largest error {err.max():.3e})")
        _require(b["routes"] == {"dist/multiclass": 2} and b["gather_rounds"] == 0,
                 f"rank {r} (b): routes {b['routes']}, gather rounds {b['gather_rounds']}")
        _require(b["launches"]["segment_sum"] == 2, f"rank {r} (b): launches {b['launches']}")
        c = res["approx"]
        _require(c["routes"] == {"sketch/binary": 1} and c["gather_rounds"] == 0,
                 f"rank {r} (c): routes {c['routes']}")
        _require(c["values"]["auroc"][0] == ref["approx_auroc"],
                 f"rank {r} (c): approx AUROC {c['values']['auroc'][0]} vs one process "
                 f"{ref['approx_auroc']}")
        _require(c["launches"]["segment_sum"] > 0, f"rank {r} (c): launches {c['launches']}")
        with np.load(os.path.join(outdir, f"rank{r}_sketch.npz")) as f:
            for k in ("tp", "fp", "nan"):
                _require(np.array_equal(f[k], ref["sketch"][k]), f"rank {r} (c): sketch {k} exactly")
        for kind, d in res["fallback"].items():
            _require(d["routes"] == {"fused/binary": 2} and d["gather_rounds"] == 2,
                     f"rank {r} (d, {kind}): routes {d['routes']}, rounds {d['gather_rounds']}")
            for k in ("auroc", "auprc"):
                _require(_close(d["values"][k][0], ref["fallback"][kind][k]),
                         f"rank {r} (d, {kind}): {k} {d['values'][k][0]} vs one process "
                         f"{ref['fallback'][kind][k]}")


# collective calls (all_reduce, all_gather, all_to_all) of two metrics'
# computes on each route: five a call raw, six with bf16, seven with int8
QUANT_COLLECTIVES = {"bf16": (6, 4, 2), "int8": (4, 6, 4)}


def check_dist_quantized(dev, ranks, outdir):
    """Gates of part (e) and of the quantized sync on every rank: values
    within rtol 1e-5 of the raw route, bit-identical on quantized scores;
    routes, collectives, launches and the exchange's bytes (5/8 and 6/8 of
    the raw rows); the error channel trips; the sketch counts exact; the
    synced integer results equal (the confusion matrix equal to
    ``torch.bincount``'s), the q8 lane within its bound, two rounds a
    sync."""
    for res in ranks:
        r, q = res["rank"], res["quantized"]
        for fam, row, kernel in (("binary", 5, "hist"), ("multiclass", 6, "segment_sum")):
            raw = res[fam]
            for mode in QUANT_MODES:
                got = q[f"{fam}/{mode}"]
                for k, v in got["values"].items():
                    a, b = np.asarray(v), np.asarray(raw["values"][k])
                    _require(a.shape == b.shape and bool(np.all(np.abs(a - b) <= ATOL + RTOL * np.abs(b))),
                             f"rank {r} (e) {fam}/{mode} {k}: largest difference from the raw route "
                             f"{np.abs(a - b).max():.3e}")
                _require(got["routes"] == {f"dist/{fam}": 2} and got["gather_rounds"] == 0,
                         f"rank {r} (e) {fam}/{mode}: routes {got['routes']}, rounds {got['gather_rounds']}")
                calls = tuple(got["collectives"][f][0] for f in
                              ("all_reduce_sum", "all_gather_stacked", "all_to_all_rows"))
                _require(calls == QUANT_COLLECTIVES[mode], f"rank {r} (e) {fam}/{mode}: collectives {calls}")
                _require(got["exchange_send_bytes"] * 8 == raw["exchange_send_bytes"] * row,
                         f"rank {r} (e) {fam}/{mode}: {got['exchange_send_bytes']} exchange bytes against "
                         f"the raw route's {raw['exchange_send_bytes']}")
                _require(got["launches"][kernel] == 2, f"rank {r} (e) {fam}/{mode}: launches {got['launches']}")
        _require(q["sketch_equal"], f"rank {r} (e): the sketch counts under the int8 knob")
        nan = q["nan/int8"]
        _require(nan["routes"] == {"fused/binary": 2} and nan["gather_rounds"] == 2,
                 f"rank {r} (e) NaN scores: routes {nan['routes']}")
        # AUROC's partial integrals are exact integer trapezoids here, so a
        # moved splitter cannot change a bit; AUPRC's are float32 sums of
        # precision fractions, which a moved splitter regroups
        for key, (equal, rel) in q["bit_equal"].items():
            _require(equal if "auroc" in key else rel <= RTOL,
                     f"rank {r} (e) quantized scores {key}: bit-equal {equal}, relative difference {rel:.3e}")
    batches = cm_leg_data(dev, torch.Generator(device=dev).manual_seed(SEED + 500))
    keys = torch.cat([label.long() * CM_CLASSES + pred.long() for pred, label in batches])
    for res in ranks:
        r, sync = res["rank"], res["sync"]
        dtype = getattr(torch, sync["True"]["cm_dtype"])
        ref = torch.bincount(keys, minlength=CM_CLASSES**2).reshape(CM_CLASSES, CM_CLASSES).to(dtype)
        _require(sync["True"]["cm_sha"] == sync["False"]["cm_sha"] == hash_bytes(ref),
                 f"rank {r} quantized sync: confusion matrix equal to torch.bincount's")
        _require(sync["True"]["sketch_auroc"] == sync["False"]["sketch_auroc"],
                 f"rank {r} quantized sync: sketch AUROC {sync['True']['sketch_auroc']} vs "
                 f"{sync['False']['sketch_auroc']}")
        for quantize in ("False", "True"):
            _require([x[0] for x in sync[quantize]["rounds"]] == ["descriptor", "payload"],
                     f"rank {r} quantized sync ({quantize}): rounds {sync[quantize]['rounds']}")
        _require(sync["True"]["rounds"][1][1] < sync["False"]["rounds"][1][1],
                 f"rank {r} quantized sync: payload bytes did not shrink")
    files = {q: [np.load(os.path.join(outdir, f"rank{r}_cal_{q}.npz")) for r in range(DIST_RANKS)]
             for q in ("False", "True")}
    worst = 0.0
    for name in ("weighted_input_sum", "weighted_label_sum"):
        # one q8 block of 256 tasks: each rank's error at most max|block| / 254
        bound = sum(float(np.abs(f[f"local_{name}"]).max()) for f in files["True"]) / 254.0
        for fq, fr in zip(files["True"], files["False"]):
            diff = float(np.abs(fq[f"synced_{name}"].astype(np.float64)
                                - fr[f"synced_{name}"].astype(np.float64)).max())
            worst = max(worst, diff / bound)
            _require(diff <= bound * (1 + 1e-5), f"quantized sync {name}: drift {diff} above its bound {bound}")
    return worst


def nccl_world_of_one(dev, gen):
    """A one-rank NCCL world through ``init_from_env``; the sharded class
    counts run one histogram launch and one NCCL all_reduce there."""
    import torch.distributed as dist

    from torcheval_tpu_torch.ops.hist import hist_plain, sharded_class_counts
    from torcheval_tpu_torch.parallel import init_from_env, shutdown

    keys = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    try:
        _require(init_from_env() == (0, 1), "NCCL world of one joined")
        _require(dist.get_backend() == "nccl", f"backend {dist.get_backend()} is nccl")
        labels = torch.randint(-3, HEADLINE_CLASSES + 3, (HEADLINE_CHUNK,), generator=gen, device=dev)
        before = K.hist
        counts = sharded_class_counts(labels, HEADLINE_CLASSES)
        torch.cuda.synchronize()
        launched = K.hist - before
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


# ------------------------------------------------ the resilience phase
def _state_words(metrics) -> dict:
    """Every state leaf of ``{key: metric}`` as a flat uint8 tensor on its
    device, keyed ``key/state/i``: the bytes a checkpoint must keep."""
    out = {}
    for key, m in metrics.items():
        for name, v in m.state_dict().items():
            leaves = list(v) if isinstance(v, (list, tuple)) else [v]
            for i, t in enumerate(leaves):
                out[f"{key}/{name}/{i}"] = t.contiguous().reshape(-1).view(torch.uint8)
    return out


def _same_words(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def _words_digest(metrics) -> dict:
    """SHA-256 of every state leaf's bytes (``_state_words``), on the host."""
    import hashlib

    return {k: hashlib.sha256(w.cpu().numpy().tobytes()).hexdigest()
            for k, w in _state_words(metrics).items()}


class _Checkpoint:
    """Context manager timing one ``save``/``restore`` call by the obs
    registry's own span and byte counter (the registry is on in every
    phase but phase 5)."""

    def __init__(self, span):
        self.span = span

    def __enter__(self):
        from torcheval_tpu_torch import obs

        snap = obs.snapshot()
        self.s0 = snap["spans"].get(self.span, {}).get("total_seconds", 0.0)
        self.b0 = snap["counters"].get("resilience.checkpoint.bytes", 0.0)
        return self

    def __exit__(self, *exc):
        from torcheval_tpu_torch import obs

        snap = obs.snapshot()
        self.seconds = snap["spans"].get(self.span, {}).get("total_seconds", 0.0) - self.s0
        self.bytes = int(snap["counters"].get("resilience.checkpoint.bytes", 0.0) - self.b0)
        return False


def _rate(nbytes, seconds) -> str:
    return f"{nbytes / seconds / 1e9:.3f} GB/s" if seconds > 0 else "-"


def resilience_headline(dev, chunks, want_acc, want_auroc, root):
    """(a) phase 3's stream checkpointed at chunks 4 and 8 (``keep_last=2``),
    a fresh pair restored from the chunk-8 generation and fed chunks 9-16:
    both values equal phase 3's bit for bit, every restored leaf equal to
    the saved one as bytes, and the resumed half compacts on the card. (d)
    one payload byte of the chunk-8 generation flipped by the chaos hook;
    ``restore_latest_valid`` quarantines it and restores the chunk-4
    generation, equal as bytes to the pair's state at chunk 4, with one
    fallback counted."""
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.metrics import BinaryAUROC, MulticlassAccuracy
    from torcheval_tpu_torch.resilience import chaos, list_checkpoints, restore, restore_latest_valid, save

    def pair():
        return {"acc": MulticlassAccuracy(num_classes=HEADLINE_CLASSES, device=dev),
                "auroc": BinaryAUROC(compaction_threshold=THRESHOLD, device=dev)}

    def feed(p, part):
        for scores, labels, logits, binary in part:
            p["acc"].update(scores, labels)
            p["auroc"].update(logits, binary)

    def values(p):
        return float(p["acc"].compute()), float(p["auroc"].compute())

    ckdir = os.path.join(root, "headline")
    K.hist = 0
    K.stream_compact = 0
    first = pair()
    feed(first, chunks[:RES_FIRST_SAVE])
    with _Checkpoint("resilience.checkpoint.save") as early:
        save(first, ckdir, keep_last=2)
    at_first = _state_words(first)
    feed(first, chunks[RES_FIRST_SAVE:RES_SAVE])
    with _Checkpoint("resilience.checkpoint.save") as saved:
        path = save(first, ckdir, keep_last=2)
    at_save = _state_words(first)
    del first
    with _Checkpoint("resilience.checkpoint.restore") as restored:
        resumed = restore(pair(), path)
    _require(_same_words(_state_words(resumed), at_save),
             "(a) every restored leaf equals the saved one as bytes")
    del at_save
    before = {"hist": K.hist, "stream_compact": K.stream_compact}
    K.hist = 0
    K.stream_compact = 0
    feed(resumed, chunks[RES_SAVE:])
    got = values(resumed)
    _require(got == (want_acc, want_auroc),
             f"(a) resumed accuracy and AUROC {got} equal phase 3's {(want_acc, want_auroc)} bit for bit")
    del resumed
    after = {"hist": K.hist, "stream_compact": K.stream_compact}
    _require(after["stream_compact"] >= 1, "(a) stream_compact launched on the resumed stream")

    # (d) lineage fallback: the chaos hook's own flip, armed for this one call
    gens = list_checkpoints(ckdir)
    _require(len(gens) == 2 and gens[-1] == path, f"(a) two generations kept: {gens}")
    armed = {"TORCHEVAL_TPU_CHAOS": "1", "TORCHEVAL_TPU_CHAOS_ACTION": "ckpt_corrupt",
             "TORCHEVAL_TPU_CHAOS_TENANT": path, "TORCHEVAL_TPU_CHAOS_STEP": "1"}
    saved_env = {k: os.environ.get(k) for k in armed}
    os.environ.update(armed)
    chaos.reset_for_tests()
    try:
        chaos.on_ckpt_saved(path)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        chaos.reset_for_tests()
    counters0 = obs.snapshot()["counters"]
    fallback = pair()
    with _Checkpoint("resilience.checkpoint.restore") as fell_back:
        got_path = restore_latest_valid(fallback, ckdir)
    counters = obs.snapshot()["counters"]
    quarantined = [n for n in os.listdir(ckdir) if n.startswith("corrupt-")]

    def delta(name):
        return counters.get(name, 0.0) - counters0.get(name, 0.0)

    _require(got_path == gens[0] and quarantined == ["corrupt-" + os.path.basename(path)],
             f"(d) restored {got_path} past the quarantined {quarantined}")
    _require(delta("resilience.checkpoint.fallback_restores") == 1.0
             and delta("resilience.checkpoint.corrupt_quarantined") == 1.0,
             "(d) one fallback restore and one quarantine counted")
    _require(_same_words(_state_words(fallback), at_first), "(d) the chunk-4 generation's bytes")
    return {"bytes": saved.bytes, "save_s": saved.seconds, "restore_s": restored.seconds,
            "early_bytes": early.bytes, "early_save_s": early.seconds,
            "fallback_restore_s": fell_back.seconds, "before": before, "after": after,
            "launches": {k: before[k] + after[k] for k in before}}


def resilience_sliced(dev, data, want, root):
    """(b) the sliced leg's collections saved after batch 8, restored into
    fresh collections of the default (smaller) capacity, fed batches 9 to
    ``RES_SLICED_BATCHES``: every integer lane and the maxima equal ``want``
    (the uninterrupted leg's states) exactly, the means within rtol 1e-5."""
    from torcheval_tpu_torch.metrics import BinaryAccuracy, BinaryAUROC, Max, Mean, SlicedMetricCollection
    from torcheval_tpu_torch.resilience import restore, save

    K.segment_sum = 0
    acc, agg = sliced_setup(dev, data)
    for i in range(1, RES_SLICED_SAVE + 1):
        ids, s, t = _sliced_batch(data, i)
        acc.update(ids, s, t)
        agg.update(ids, s)
    grown = acc.slice_table.capacity
    with _Checkpoint("resilience.checkpoint.save") as saved:
        paths = [save(acc, os.path.join(root, "sliced_acc")), save(agg, os.path.join(root, "sliced_agg"))]
    del acc, agg
    fresh_acc = SlicedMetricCollection(
        {"acc": BinaryAccuracy(device=dev), "auroc": BinaryAUROC(approx=1024, device=dev)},
        curve_bucket_bits=SLICED_BITS)
    fresh_agg = SlicedMetricCollection({"mean": Mean(device=dev), "max": Max(device=dev)})
    fresh_capacity = fresh_acc.slice_table.capacity
    _require(fresh_capacity < grown, f"(b) the fresh capacity {fresh_capacity} below the grown {grown}")
    with _Checkpoint("resilience.checkpoint.restore") as restored:
        restore(fresh_acc, paths[0])
        restore(fresh_agg, paths[1])
    for i in range(RES_SLICED_SAVE + 1, RES_SLICED_BATCHES + 1):
        ids, s, t = _sliced_batch(data, i)
        fresh_acc.update(ids, s, t)
        fresh_agg.update(ids, s)
    results = {**fresh_acc.compute(), **fresh_agg.compute()}
    torch.cuda.synchronize()
    launches = K.segment_sum
    _require(launches > 0, "(b) segment_sum launched on the restored collections")
    _require(np.array_equal(results["acc"].slice_ids, want["ids"]), "(b) slice ids in first-seen order")
    n = len(want["ids"])
    for key, member in (("acc", fresh_acc.metrics["acc"]), ("auroc", fresh_acc.metrics["auroc"]),
                        ("max", fresh_agg.metrics["max"])):
        sd = member.state_dict()
        for name, w in want[key].items():
            _require(torch.equal(sd[name][:n], w), f"(b) {key}.{name} equals the uninterrupted leg's")
    got_mean = results["mean"]["values"].cpu().numpy().astype(np.float64)
    err = np.abs(got_mean - want["mean"])
    rel = np.divide(err, np.abs(want["mean"]), out=np.where(err == 0, 0.0, np.inf),
                    where=want["mean"] != 0)
    _require(bool(np.all(rel <= RTOL)), f"(b) per-cohort means within rtol 1e-5 ({rel.max():.3e})")
    return {"bytes": saved.bytes, "save_s": saved.seconds, "restore_s": restored.seconds,
            "launches": launches, "grown": grown, "fresh": fresh_capacity, "mean_rel": float(rel.max())}


def sliced_want(acc, agg, results) -> dict:
    """The uninterrupted sliced leg's integer lanes and maxima (on the card)
    and its means (float64, host), for (b)."""
    n = len(results["acc"].slice_ids)
    pick = {"acc": ("num_correct", "num_total"), "auroc": ("sketch_tp", "sketch_fp", "sketch_nan_dropped")}
    want = {"ids": results["acc"].slice_ids,
            "mean": results["mean"]["values"].cpu().numpy().astype(np.float64)}
    for key, names in pick.items():
        sd = acc.metrics[key].state_dict()
        want[key] = {name: sd[name][:n] for name in names}
    want["max"] = {"max": agg.metrics["max"].state_dict()["max"][:n]}
    return want


def _drill_metrics(dev):
    from torcheval_tpu_torch.metrics import BinaryAUROC, MulticlassAccuracy, MulticlassF1Score

    return {"accuracy": MulticlassAccuracy(num_classes=HEADLINE_CLASSES, device=dev),
            "f1_macro": MulticlassF1Score(num_classes=HEADLINE_CLASSES, average="macro", device=dev),
            "auroc": BinaryAUROC(compaction_threshold=DP_THRESHOLD, device=dev)}


def drill_worker(rank: int, port: str, outdir: str, phase: str) -> int:
    """One rank of the kill drill (``chip_smoke.py --drill-rank R PORT DIR
    PHASE``), on ``cuda:0`` over gloo, with the data-parallel leg's chunks
    and ``dp_worker``'s metrics. ``fault``: feed 2 of its 4 chunks, save
    to ``DIR/rank<R>`` (printing ``DRILL_SAVED`` with the saved leaves'
    digests), sync (rounds 1-2), feed the other 2, print ``DRILL_PRE`` and
    sync again under ``timeout_s=DRILL_TIMEOUT_S``, ``on_failure="local"``;
    the chaos hook kills rank 1 entering round 3, and rank 0 prints its
    degraded ``DRILL_RESULT`` and leaves with ``os._exit(0)``. ``restart``:
    restore ``DIR/rank<R>``, feed chunks 3-4 of this rank and compute
    through the ``ShardedEvaluator``s, as ``dp_worker`` does."""
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.utils.test_utils.obs_counts import count, rounds
    from torcheval_tpu_torch.metrics import toolkit
    from torcheval_tpu_torch.parallel import ShardedEvaluator, data_parallel_mesh, init_from_env, shutdown
    from torcheval_tpu_torch.resilience import restore, save

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=str(DP_RANKS),
                      RANK=str(rank), LOCAL_RANK="0")
    obs.enable()  # every count this rank reports is the registry's
    _require(init_from_env(backend="gloo") == (rank, DP_RANKS), "drill rank joined")
    mesh = data_parallel_mesh()
    dev = mesh.device
    per_rank = DP_CHUNKS // DP_RANKS
    mine = list(range(rank * per_rank, (rank + 1) * per_rank))
    held = _drill_metrics(dev)
    classification = ShardedEvaluator({k: held[k] for k in ("accuracy", "f1_macro")}, mesh=mesh)
    auroc = ShardedEvaluator(held["auroc"], mesh=mesh)

    def feed(indices):
        for i in indices:
            scores, labels, logits, binary = dp_chunk(dev, i)
            classification.update(scores, labels)
            auroc.update(logits, binary)

    K.hist = 0
    K.stream_compact = 0
    ckpt = os.path.join(outdir, f"rank{rank}")
    if phase == "fault":
        feed(mine[:DRILL_PRE_CHUNKS])
        save(held, ckpt)
        print("DRILL_SAVED " + json.dumps({"rank": rank, "digest": _words_digest(held)}), flush=True)
        toolkit.sync_and_compute_collection(held, recipient_rank="all", processes=mesh.processes,
                                            timeout_s=DP_TIMEOUT_S)
        feed(mine[DRILL_PRE_CHUNKS:])
        torch.cuda.synchronize()
        print("DRILL_PRE " + json.dumps({"rank": rank, "rounds": rounds(),
                                         "hist_launches": K.hist,
                                         "stream_compact_launches": K.stream_compact}), flush=True)
        failures0 = count("toolkit.sync.timeouts")
        t0 = time.monotonic()
        got = toolkit.sync_and_compute_collection(held, recipient_rank="all", processes=mesh.processes,
                                                  timeout_s=DRILL_TIMEOUT_S, on_failure="local")
        elapsed = time.monotonic() - t0
        local = {k: m.compute() for k, m in held.items()}
        out = {"rank": rank, "elapsed_s": elapsed, "failures": int(count("toolkit.sync.timeouts") - failures0),
               "local": all(torch.equal(got[k], local[k]) for k in held),
               "values": {k: float(v) for k, v in got.items()},
               "hist_launches": K.hist, "stream_compact_launches": K.stream_compact}
        print("DRILL_RESULT " + json.dumps(out), flush=True)
        sys.stderr.flush()
        # the round thread may still be blocked on the dead peer: destroying
        # the group could wait on it
        os._exit(0)
    restore(held, ckpt)
    feed(mine[DRILL_PRE_CHUNKS:])
    results = classification.compute()
    auroc_v = float(auroc.compute())
    out = {"rank": rank, "accuracy": float(results["accuracy"]), "f1_macro": float(results["f1_macro"]),
           "auroc": auroc_v, "hist_launches": K.hist,
           "stream_compact_launches": K.stream_compact}
    for name in ("accuracy", "f1_macro"):
        sd = toolkit.get_synced_state_dict(classification.metrics[name], recipient_rank="all")
        out[f"{name}_counts"] = {k: v.cpu().tolist() for k, v in sd.items()}
    shutdown()
    print("DRILL_RESULT " + json.dumps(out), flush=True)
    return 0


def spawn_drill(phase, outdir, env_extra, expect):
    """Both drill ranks' ``DRILL_*`` lines, ``[{tag: [objects]}]``."""
    return [tagged_lines(out, "DRILL_")
            for out in run_ranks("--drill-rank", DP_RANKS, DP_TIMEOUT_S, (outdir, phase), env_extra, expect)]


def resilience_drill(dev, root, counts, acc_ref, f1_ref, auroc_ref):
    """(c) the kill drill: rank 1 dies with exit 43 entering the second
    sync, rank 0 degrades to its local values within ``DRILL_TIMEOUT_S``
    with one failure counted; each rank's pre-fault checkpoint restores on
    the card to the leaves it saved; two fresh ranks restore them, feed
    their chunks 3-4 and sync, and pass the data-parallel leg's gate."""
    outdir = os.path.join(root, "drill")
    os.makedirs(outdir)
    armed = {"TORCHEVAL_TPU_CHAOS": "1", "TORCHEVAL_TPU_CHAOS_ACTION": "kill",
             "TORCHEVAL_TPU_CHAOS_RANK": "1", "TORCHEVAL_TPU_CHAOS_ROUND": "3",
             "TORCHEVAL_TPU_CHAOS_EXIT_CODE": str(DRILL_EXIT_CODE)}
    t0 = time.perf_counter()
    fault = spawn_drill("fault", outdir, armed, {0: 0, 1: DRILL_EXIT_CODE})
    fault_s = time.perf_counter() - t0
    for r in range(DP_RANKS):
        _require(len(fault[r].get("DRILL_SAVED", [])) == 1 and len(fault[r].get("DRILL_PRE", [])) == 1,
                 f"(c) rank {r} saved and synced once before the fault")
        _require(fault[r]["DRILL_PRE"][0]["rounds"] == 2, f"(c) rank {r}: the first sync was rounds 1-2")
    _require("DRILL_RESULT" not in fault[1], "(c) rank 1 died before its second sync returned")
    r0 = fault[0]["DRILL_RESULT"][0]
    _require(r0["failures"] == 1 and r0["local"], f"(c) rank 0 degraded to its local values: {r0}")
    _require(r0["elapsed_s"] <= DRILL_TIMEOUT_S + 5.0,
             f"(c) rank 0 returned in {r0['elapsed_s']:.3f} s, deadline {DRILL_TIMEOUT_S} s")
    from torcheval_tpu_torch.resilience import restore

    restore_s = []
    for r in range(DP_RANKS):
        with _Checkpoint("resilience.checkpoint.restore") as ck:
            fresh = restore(_drill_metrics(dev), os.path.join(outdir, f"rank{r}"))
        restore_s.append(ck.seconds)
        _require(_words_digest(fresh) == fault[r]["DRILL_SAVED"][0]["digest"],
                 f"(c) rank {r}'s pre-fault checkpoint restores on the card to the saved leaves")
        del fresh
    t0 = time.perf_counter()
    restart = [lines["DRILL_RESULT"][0] for lines in spawn_drill("restart", outdir, {}, {0: 0, 1: 0})]
    restart_s = time.perf_counter() - t0
    for res in restart:
        r = res["rank"]
        _require(res["accuracy_counts"] == counts["accuracy"], f"(c) restarted rank {r} accuracy counts")
        _require(res["f1_macro_counts"] == counts["f1_macro"], f"(c) restarted rank {r} F1 counts")
        _require(_close(res["accuracy"], acc_ref) and _close(res["f1_macro"], f1_ref),
                 f"(c) restarted rank {r} accuracy {res['accuracy']} and F1 {res['f1_macro']}")
        _require(np.isfinite(res["auroc"]) and _close(res["auroc"], auroc_ref),
                 f"(c) restarted rank {r} AUROC {res['auroc']} vs uncompacted {auroc_ref}")
    pre = [fault[r]["DRILL_PRE"][0] for r in range(DP_RANKS)]
    launches = {
        "hist": r0["hist_launches"] + pre[1]["hist_launches"] + sum(x["hist_launches"] for x in restart),
        "stream_compact": r0["stream_compact_launches"] + pre[1]["stream_compact_launches"]
        + sum(x["stream_compact_launches"] for x in restart),
    }
    _require(launches["hist"] > 0 and launches["stream_compact"] > 0,
             "(c) hist and stream_compact launched by the drill's ranks")
    return {"rank0": r0, "fault_s": fault_s, "restart_s": restart_s, "restore_s": restore_s,
            "restart": restart, "launches": launches, "pre": pre}


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
    # the binned curve's stacked window: int32 ones by B * bins + key
    bins = 2 * CURVE_CLASSES * (CURVE_THRESHOLDS + 1)
    segments = CURVE_BATCHES * bins
    g = torch.Generator(device=dev).manual_seed(SEED)
    keys = torch.randint(0, segments, (CURVE_BATCHES * CURVE_ROWS * CURVE_CLASSES,), generator=g,
                         device=dev)
    ones = torch.ones(keys.shape[0], dtype=torch.int32, device=dev)

    def library():
        return torch.zeros(segments, dtype=torch.int32, device=dev).index_add_(0, keys, ones)

    row["at_binned_window"] = {
        "rows": keys.numel(),
        "segments": segments,
        "ms": timer.ms(lambda: segment_sum(ones, keys, segments)),
        "plain_ms": timer.ms(lambda: segment_sum_plain(ones, keys, segments)),
        "bound_ms": (keys.numel() * (4 + 8) + segments * 4) / HBM_BYTES_PER_S * 1e3,
        "library_ms": timer.ms(library),
    }
    return row


def sketch_rows(timer, inputs, launches_at, err):
    """The segment sum at the four sketch-fold shapes (phase 2's operands),
    beside its plain version and ``index_add_`` into a zeroed output (the
    library); ``launches_at[name]``: the main path's launches at that
    shape."""
    from torcheval_tpu_torch.ops.scatter import segment_sum, segment_sum_plain

    rows = []
    for name, (vals, keys, segments, what) in inputs.items():
        n = keys.numel()
        d = 1 if vals.ndim == 1 else vals.shape[1]

        def library(vals=vals, keys=keys, segments=segments):
            return torch.zeros((segments,) + vals.shape[1:], dtype=vals.dtype,
                               device=vals.device).index_add_(0, keys, vals)

        rows.append({
            "name": f"segment_sum_sketch_{name}",
            "route": "cuda",
            "source": "torcheval_tpu_torch/csrc/scatter.cu",
            "replaces": "torcheval_tpu/ops/scatter.py:95",
            "launches": launches_at[name],
            "max_abs_err": err,
            "ms": timer.ms(lambda: segment_sum(vals, keys, segments)),
            "plain_ms": timer.ms(lambda: segment_sum_plain(vals, keys, segments)),
            # values and keys read once, the (segments, D) int32 output written once
            "bound_ms": (n * d * 4 + n * keys.element_size() + segments * d * 4) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": timer.ms(library),
            "shape": what,
        })
    return rows


def _topk_times(dev, gen, timer, n, l, k):
    from torcheval_tpu_torch.ops.topk import topk_kernel, topk_kernel_plain

    x = torch.rand((n, l), generator=gen, device=dev)
    # each score read once, each value (4 B) and int64 index (8 B) written once
    return {
        "ms": timer.ms(lambda: topk_kernel(x, k)),
        "plain_ms": timer.ms(lambda: topk_kernel_plain(x, k)),
        "bound_ms": (n * l * 4 + n * k * 12) / HBM_BYTES_PER_S * 1e3,
        "library_ms": timer.ms(lambda: torch.topk(x, k)),
    }


def topk_row(dev, gen, timer, launches, err):
    from torcheval_tpu_torch.ops.topk import topk_kernel

    def times(n, l, k):
        return _topk_times(dev, gen, timer, n, l, k)

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


def shard_rows(dev, gen, timer, launches, errs, window):
    """The sharded leg's kernels at the shapes one rank gives them: the
    top-k at a (64, 500,000) label tile (k = 100, and 10 beside it) and at
    a (32, 10^6) row block; the segment sum at the slice tile and at the
    tile's sketch fold (``index_add_`` into a dead extra segment as the
    library, its index remapped before the timing); and the sharded segment
    sum's local launch over half of the sliced window (its all_reduce is
    the ranks' to time)."""
    from torcheval_tpu_torch.ops.scatter import segment_sum, segment_sum_plain

    rows = []
    label = {"name": "topk_label_tile", "route": "cuda", "source": "torcheval_tpu_torch/csrc/topk.cu",
             "replaces": "torcheval_tpu/ops/topk.py:520", "launches": launches["topk_label"],
             "max_abs_err": errs["topk"],
             **_topk_times(dev, gen, timer, RETRIEVAL_ROWS, SHARD_LABELS, 100), "bound_by": "bytes",
             "shape": f"({RETRIEVAL_ROWS}, {SHARD_LABELS}) float32 label tile, k=100 (sharded_label_topk)"}
    label["at_k10"] = _topk_times(dev, gen, timer, RETRIEVAL_ROWS, SHARD_LABELS, 10)
    rows.append(label)
    block = RETRIEVAL_ROWS // SHARD_RANKS
    rows.append({"name": "topk_row_block", "route": "cuda", "source": "torcheval_tpu_torch/csrc/topk.cu",
                 "replaces": "torcheval_tpu/ops/topk.py:354", "launches": launches["topk_row"],
                 "max_abs_err": errs["topk"],
                 **_topk_times(dev, gen, timer, block, RETRIEVAL_LABELS, 100), "bound_by": "bytes",
                 "shape": f"({block}, {RETRIEVAL_LABELS}) float32 row block, k=100 (sharded_topk_kernel)"})
    for name, (vals, keys, segments, what) in slice_tile_inputs(dev).items():
        n = keys.numel()
        d = 1 if vals.ndim == 1 else vals.shape[1]
        dead = torch.where((keys >= 0) & (keys < segments), keys, segments)

        def library(vals=vals, dead=dead, segments=segments):
            return torch.zeros((segments + 1,) + vals.shape[1:], dtype=vals.dtype,
                               device=vals.device).index_add_(0, dead, vals)

        rows.append({
            "name": f"segment_sum_{name}",
            "route": "cuda",
            "source": "torcheval_tpu_torch/csrc/scatter.cu",
            "replaces": ("torcheval_tpu/ops/scatter.py:242" if name == "slice_tile"
                         else "torcheval_tpu/sketch/cache.py:471"),
            "launches": launches[f"segment_sum_{name}"],
            "max_abs_err": errs["segment_sum_tile"],
            "ms": timer.ms(lambda: segment_sum(vals, keys, segments)),
            "plain_ms": timer.ms(lambda: segment_sum_plain(vals, keys, segments)),
            # every sample's values and row read once, the tile written once
            "bound_ms": (n * d * 4 + n * keys.element_size() + segments * d * 4) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": timer.ms(library),
            "shape": what,
        })
        del dead
    w_rows, w_scores, w_targets = window
    half = w_rows.shape[0] // SHARD_RANKS
    correct = ((w_scores[:half] >= 0.5).to(torch.float32) == w_targets[:half]).to(torch.int32)
    deltas = torch.stack([correct, torch.ones_like(correct)], dim=-1)
    r = w_rows[:half]
    s = SLICED_COHORTS
    _require(torch.equal(segment_sum(deltas, r, s), segment_sum_plain(deltas, r, s)),
             "segment_sum at one rank's half of the sliced window")

    def library():
        return torch.zeros((s, 2), dtype=torch.int32, device=dev).index_add_(0, r, deltas)

    rows.append({
        "name": "sharded_segment_sum",
        "route": "cuda",
        "source": "torcheval_tpu_torch/csrc/scatter.cu",
        "replaces": "torcheval_tpu/ops/scatter.py:370",
        "launches": launches["sharded_segment_sum"],
        "max_abs_err": 0.0,
        "ms": timer.ms(lambda: segment_sum(deltas, r, s)),
        "plain_ms": timer.ms(lambda: segment_sum_plain(deltas, r, s)),
        "bound_ms": (half * 2 * 4 + half * 4 + s * 2 * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": timer.ms(library),
        "shape": (f"one rank's local sum: ({half}, 2) int32 deltas, half of the sliced window, "
                  f"into {s} cohorts (then one all_reduce of the (10^6, 2) sums)"),
    })
    return rows


def hist_c2_row(dev, timer, launches, keys):
    """The histogram at config 3's confusion-matrix shape: the window's
    1,300,000 int32 joint keys into C^2 = 10^6 bins, beside
    ``torch.bincount`` (the library) and the segment sum on the same keys."""
    from torcheval_tpu_torch.ops.hist import hist, hist_plain
    from torcheval_tpu_torch.ops.scatter import segment_sum

    c2 = CM_CLASSES * CM_CLASSES
    ones = torch.ones(keys.shape[0], dtype=torch.int32, device=dev)
    err = int((hist(keys, c2).long() - hist_plain(keys, c2).long()).abs().max())
    _require(err == 0, "hist at C^2 against its plain version")
    return {
        "name": "hist_c2",
        "route": "cuda",
        "source": "torcheval_tpu_torch/csrc/hist.cu",
        "replaces": "torcheval_tpu/ops/pallas_hist.py:55",
        "launches": launches,
        "max_abs_err": float(err),
        "ms": timer.ms(lambda: hist(keys, c2)),
        "plain_ms": timer.ms(lambda: hist_plain(keys, c2)),
        "bound_ms": (keys.numel() * keys.element_size() + c2 * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": timer.ms(lambda: torch.bincount(keys, minlength=c2)),
        "segment_sum_ms": timer.ms(lambda: segment_sum(ones, keys, c2)),
        "shape": (f"config 3's window: ({keys.numel()},) int32 joint keys into {c2} bins; launches: "
                  "every hist launch of the config-3 leg, its C^2 launch and F1's two a fold"),
    }


def dist_rows(dev, timer, launches):
    """The two kernels at the distributed-curves leg's splitter shapes, each
    held bit-equal to its plain version first: the histogram over rank 0's
    2^26 splitter bins of part (a) (the top 16 bits of its order keys) into
    2^16 bins, beside ``torch.bincount``; and the segment sum over rank 0's
    3 x 10^7 combined keys ``c * 2^16 + bin`` of part (b), int32 ones into
    1000 x 2^16 rows, beside ``index_add_``."""
    from torcheval_tpu_torch.ops import dist_curves as dc
    from torcheval_tpu_torch.ops.hist import hist, hist_plain
    from torcheval_tpu_torch.ops.scatter import segment_sum, segment_sum_plain

    per = DP_CHUNKS // DIST_RANKS
    bins = dc.splitter_bins(dc.order_key(torch.cat([dp_chunk(dev, i)[2] for i in range(per)])))
    err = int((hist(bins, dc.HIST_BINS).long() - hist_plain(bins, dc.HIST_BINS).long()).abs().max())
    _require(err == 0, "hist at the binary splitter shape against its plain version")
    rows = [{
        "name": "hist_splitter",
        "route": "cuda",
        "source": "torcheval_tpu_torch/csrc/hist.cu",
        "replaces": "torcheval_tpu/ops/pallas_hist.py:55",
        "launches": launches["hist_splitter"],
        "max_abs_err": float(err),
        "ms": timer.ms(lambda: hist(bins, dc.HIST_BINS)),
        "plain_ms": timer.ms(lambda: hist_plain(bins, dc.HIST_BINS)),
        "bound_ms": (bins.numel() * bins.element_size() + dc.HIST_BINS * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": timer.ms(lambda: torch.bincount(bins, minlength=dc.HIST_BINS)),
        "shape": (f"binary splitter: ({bins.numel()},) int32 bins into {dc.HIST_BINS}, one rank's "
                  "data-parallel chunks; launches: the distributed-curves leg's parts (a) and (e)"),
    }]
    del bins
    x = torch.cat([b[0] for b in dist_curve_batches(dev)[: DIST_CURVE_SPLIT[0]]])
    offset = torch.arange(CURVE_CLASSES, dtype=torch.int32, device=dev)[:, None] * dc.HIST_BINS
    keys = (dc.splitter_bins(dc.order_key(x.T)) + offset).reshape(-1)
    del x, offset
    ones = torch.ones_like(keys)
    segments = CURVE_CLASSES * dc.HIST_BINS
    err = int((segment_sum(ones, keys, segments).long()
               - segment_sum_plain(ones, keys, segments).long()).abs().max())
    _require(err == 0, "segment_sum at the multiclass splitter shape against its plain version")

    def library():
        return torch.zeros(segments, dtype=torch.int32, device=dev).index_add_(0, keys, ones)

    rows.append({
        "name": "segment_sum_splitter",
        "route": "cuda",
        "source": "torcheval_tpu_torch/csrc/scatter.cu",
        "replaces": "torcheval_tpu/ops/scatter.py:95",
        "launches": launches["segment_sum_splitter"],
        "max_abs_err": float(err),
        "ms": timer.ms(lambda: segment_sum(ones, keys, segments)),
        "plain_ms": timer.ms(lambda: segment_sum_plain(ones, keys, segments)),
        "bound_ms": (keys.numel() * 4 * 2 + segments * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": timer.ms(library),
        "shape": (f"multiclass splitter: ({keys.numel()},) int32 ones by c * 2^16 + bin into "
                  f"{segments} rows, one rank's 3 curve batches; launches: parts (b) and (e)"),
    })
    return rows


def curve_fold_inputs(batches):
    """The per-class fold's inputs at the curve leg's first compaction: the
    first 20,000 rows' (C, M) count columns padded to M = 32,768, sorted
    and tie-merged (the compaction's input, flattened), and the columns."""
    from torcheval_tpu_torch.metrics.classification.auroc import _mc_combined_counts, _pad_cap
    from torcheval_tpu_torch.ops.summary import PAD_SCORE, _sorted_deltas

    k = CURVE_COMPACTION // CURVE_ROWS
    s, tp, fp = _mc_combined_counts([b[0] for b in batches[:k]], [b[1] for b in batches[:k]],
                                    [], [], [], CURVE_CLASSES)
    pad = (CURVE_CLASSES, _pad_cap(s.shape[1]) - s.shape[1])
    s = torch.cat([s, s.new_full(pad, PAD_SCORE)], dim=1)
    tp = torch.cat([tp, tp.new_zeros(pad)], dim=1)
    fp = torch.cat([fp, fp.new_zeros(pad)], dim=1)
    ss, dtp, dfp, keep, _ = _sorted_deltas(s, tp, fp)
    return (ss.reshape(-1), dtp.reshape(-1), dfp.reshape(-1), keep.reshape(-1)), (s, tp, fp)


def compact_rows_row(timer, launches, fold):
    """The compaction kernel over the flattened C * M rows of the curve
    leg's first per-class fold, beside boolean-mask indexing (the library);
    and, as information, the whole per-class fold both ways."""
    from torcheval_tpu_torch.ops.stream_compact import (
        compact_summary_rows,
        compact_summary_rows_plain,
    )
    from torcheval_tpu_torch.ops.summary import compact_count_rows, compact_count_rows_fast

    (s, tp, fp, keep), cols = fold
    n = s.numel()
    stacked = torch.stack([s.view(torch.int32), tp, fp])
    got = compact_summary_rows(s, tp, fp, keep)
    want = compact_summary_rows_plain(s, tp, fp, keep)
    torch.cuda.synchronize()
    err = max(int((g.view(torch.int32).long() - w.view(torch.int32).long()).abs().max())
              for g, w in zip(got[:3], want[:3]))
    _require(err == 0 and int(got[3]) == int(want[3]), "compaction at the per-class fold's rows")
    return {
        "name": "stream_compact_rows",
        "route": "cuda",
        "source": "torcheval_tpu_torch/csrc/stream_compact.cu",
        "replaces": "torcheval_tpu/ops/stream_compact.py:103",
        "launches": launches,
        "max_abs_err": float(err),
        "ms": timer.ms(lambda: compact_summary_rows(s, tp, fp, keep)),
        "plain_ms": timer.ms(lambda: compact_summary_rows_plain(s, tp, fp, keep)),
        "bound_ms": n * (keep.element_size() + 3 * 4 + 3 * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": timer.ms(lambda: stacked[:, keep]),
        "fold": {"fast_ms": timer.ms(lambda: compact_count_rows_fast(*cols), reps=5),
                 "two_sort_ms": timer.ms(lambda: compact_count_rows(*cols), reps=5)},
        "shape": (f"the curve leg's first per-class fold, flattened: {n} rows "
                  f"({CURVE_CLASSES} x {n // CURVE_CLASSES}), {int(keep.sum())} kept; launches: "
                  "the curve leg's"),
    }


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
    from torcheval_tpu_torch import _build, obs

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

    # the obs registry counts every launch, fold and round from here on
    # (phase 5 times its kernels with it off)
    obs.enable()
    print("phase 2 kernels against their plain versions")
    errs = {"hist": check_hist(dev, gen), "stream_compact": check_compaction(dev, gen),
            "topk": check_topk(dev, gen), "segment_sum": check_segment_sum(dev)}
    # made again from the same seed in phase 5: not resident through the legs
    errs["segment_sum_sketch"] = check_sketch_folds(dev, sketch_fold_inputs(dev, sketch_gen(dev)))
    errs["segment_sum_tile"] = check_slice_tiles(slice_tile_inputs(dev))
    check_sliced_sketch_spread(dev)
    check_compact_counts(dev, gen, fold_scores, fold_t)
    check_classification_shapes(dev, gen)
    del fold_scores, fold_t
    torch.cuda.synchronize()

    print("phase 3 headline leg")
    obs.reset()  # every count 0 just before the main path
    K.hist = 0
    K.stream_compact = 0
    folds0 = fold_counts()
    acc, acc_v, auroc_v, seconds, host_seconds, peak = headline_leg(dev, chunks)
    headline_launches = {"hist": K.hist, "stream_compact": K.stream_compact}
    headline_cadence = cadence(folds0)
    total = HEADLINE_CHUNKS * HEADLINE_CHUNK
    _require(K.stream_compact >= 2, f"stream_compact launches {K.stream_compact} >= 2")
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
    del acc

    print("obs phase on phase 3's data (headline; small-batch leg from its own seed)")
    small = small_batch_data(dev, torch.Generator(device=dev).manual_seed(OBS_SMALL_SEED))
    rates = obs_on_off(dev, chunks, (acc_v, auroc_v), small)
    del small
    obs_ratios = {}
    for leg, unit in (("headline", "preds/s"), ("small", "rows/s")):
        off, on = _median(rates[leg][False]), _median(rates[leg][True])
        obs_ratios[leg] = on / off
        print(f"  (a) {leg}: median {off:.1f} {unit} with obs off, {on:.1f} with obs on: on/off "
              f"{on / off:.4f} (runs off {[round(x, 1) for x in rates[leg][False]]}, on "
              f"{[round(x, 1) for x in rates[leg][True]]}); values equal bit for bit in every run")
    ob = obs_registry_check(dev, chunks, (acc_v, auroc_v), headline_launches)
    print(f"  (b) one enabled run: {ob['spans']} span paths; launches {ob['launches']} (C entry calls "
          f"{ob['c_entry_calls']}); first sights by entry {ob['traces']}, no storm warning; "
          f"compactions at {ob['compact_rows']} rows, obs.cost.bytes_accessed {ob['compact_bytes']} B "
          f"(phase 5's count); Chrome trace of {ob['trace_events']} events parses with nested spans; "
          f"{ob['prometheus_lines']} Prometheus sample lines in the exposition format")
    oc = obs_profile(dev, chunks)
    print(f"  (c) under torch.profiler: {oc['kernels']} hist/compaction kernels, each inside a "
          f"metric/collection/jit range; device {oc['device_ms']:.3f} ms in all")
    print(f"  (c) device ms by metric (outermost range): "
          f"{ {k: round(v, 3) for k, v in sorted(oc['outer_ms'].items(), key=lambda kv: -kv[1])} }")
    print(f"  (c) device ms by innermost range: "
          f"{ {k: round(v, 3) for k, v in sorted(oc['inner_ms'].items(), key=lambda kv: -kv[1])} }")
    print(f"  (c) outside every range, the largest device events (information): {oc['unranged']}")

    # the resilience phase's checkpoints: removed at the end, or at exit
    res_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    atexit.register(shutil.rmtree, res_root, True)
    usage = shutil.disk_usage(res_root)
    print(f"resilience phase (a), (d) on phase 3's chunks, checkpoints under {res_root} (disk total "
          f"{usage.total} B, used {usage.used} B, free {usage.free} B)")
    ra = resilience_headline(dev, chunks, acc_v, auroc_v, res_root)
    shutil.rmtree(os.path.join(res_root, "headline"))
    print(f"  (a) chunks 1-{RES_SAVE} saved ({ra['bytes']} B in {ra['save_s']:.4f} s, "
          f"{_rate(ra['bytes'], ra['save_s'])}; the chunk-{RES_FIRST_SAVE} generation {ra['early_bytes']} B "
          f"in {ra['early_save_s']:.4f} s, {_rate(ra['early_bytes'], ra['early_save_s'])}), restored into a "
          f"fresh pair in {ra['restore_s']:.4f} s ({_rate(ra['bytes'], ra['restore_s'])}; the "
          f"resilience.checkpoint spans), every leaf equal as bytes; chunks {RES_SAVE + 1}-"
          f"{HEADLINE_CHUNKS} fed: accuracy and AUROC equal phase 3's bit for bit; launches before the "
          f"save {ra['before']}, after the restore {ra['after']}")
    print(f"  (d) one payload byte of the chunk-{RES_SAVE} generation flipped by the chaos hook: "
          f"restore_latest_valid quarantined it and restored the chunk-{RES_FIRST_SAVE} generation in "
          f"{ra['fallback_restore_s']:.4f} s (checksum of the corrupt one included), every leaf equal "
          f"as bytes to the chunk-{RES_FIRST_SAVE} state, one fallback counted")

    print("phase 4 approximate headline leg (phase 3's data)")
    approx_headline_leg(dev, chunks[:1])  # warm-up: the first use of each PyTorch kernel
    K.segment_sum = 0
    with record_sketch_folds() as rec:
        metrics, values, ah_s, ah_host, ah_peak = approx_headline_leg(dev, chunks)
    approx_headline_launches = K.segment_sum
    sketch_launches = {"binary": rec.count(n=HEADLINE_CHUNK, d=2, segments=1 << SKETCH_BITS),
                       "quantile": rec.count(n=QUANTILE_STACK * HEADLINE_CHUNK, d=1,
                                             segments=QUANTILE_STACK << SKETCH_BITS)}
    _require(approx_headline_launches > 0 and sketch_launches["binary"] > 0
             and sketch_launches["quantile"] > 0,
             "segment_sum launched on the approximate headline leg, binary and Quantile folds")
    _require(sketch_launches["binary"] + sketch_launches["quantile"] == len(rec.shapes),
             f"every sketch fold of the approximate headline leg at a checked shape: {rec.shapes}")
    ah = check_approx_headline(chunks, metrics, values, auroc_v)
    print(f"  {total} predictions in {ah_s:.4f} s (CUDA events): {total / ah_s:.1f} preds/s "
          f"({ah_host:.4f} s on the host clock); peak memory {ah_peak[0] / 2**30:.2f} GiB "
          f"(incl. {HEADLINE_CHUNKS} resident input chunks; the leg's own {ah_peak[1] / 2**30:.2f} "
          f"GiB above what was allocated at its start); the exact headline: "
          f"{total / seconds:.1f} preds/s, {peak / 2**30:.2f} GiB")
    print(f"  approx AUROC {values[0]:.8f} vs exact {auroc_v:.8f}: |error| {ah['auroc_err']:.3e} "
          f"within the sketch's bound {ah['auroc_bound']:.3e}; approx AUPRC {values[1]:.8f} vs exact "
          f"average precision {ah['auprc_exact']:.8f}: |error| {ah['auprc_err']:.3e} within "
          f"{ah['auprc_bound']:.3e}; counts sum to {total}")
    print(f"  quantiles {QUANTILES}: {values[2]} within {max(ah['quantile_rel_err']):.3e} (relative) "
          f"of the order statistics of a sort on the card (bound 2^-7)")
    print(f"  segment_sum launches {approx_headline_launches} ({sketch_launches['binary']} binary folds "
          f"of (2^24, 2), {sketch_launches['quantile']} Quantile stacked value folds of "
          f"({QUANTILE_STACK} * 2^24,))")
    del chunks, metrics
    torch.cuda.empty_cache()

    print("phase 4 macro leg")
    K.hist = 0
    K.stream_compact = 0
    folds0 = fold_counts()
    macro_v, update_ms = macro_leg(dev, gen)
    macro_launches = {"hist": K.hist, "stream_compact": K.stream_compact}
    macro_cadence = cadence(folds0)
    _require(K.hist > 0, "hist launched on the macro leg")
    hist_bytes = MACRO_CHUNK * 8 + MACRO_CLASSES * 4  # phase 5's byte count at this shape
    hist_gauge = obs.snapshot()["gauges"].get("obs.cost.bytes_accessed{entry=hist}")
    _require(hist_gauge == hist_bytes,
             f"(b) obs.cost.bytes_accessed{{entry=hist}} {hist_gauge} vs phase 5's {hist_bytes}")
    macro_total = MACRO_CHUNKS * MACRO_CHUNK
    print(f"  macro accuracy {macro_v:.8f} over {macro_total} rows (counts equal the plain "
          f"histogram); update time {update_ms:.3f} ms: {macro_total / update_ms * 1e3:.1f} "
          f"preds/s; launches {macro_launches}; obs.cost.bytes_accessed{{entry=hist}} "
          f"{hist_gauge:.0f} B, phase 5's count")
    print(f"  fold cadence: {cadence_text(macro_cadence)}")

    print("phase 4 small-batch leg (BASELINE config 1, with distinct batches)")
    batches = small_batch_data(dev, gen)
    small_batch_leg(dev, batches)  # warm-up: the first use of each PyTorch kernel
    small_batch_standalone(dev, batches)
    K.hist = 0
    K.stream_compact = 0
    folds0 = fold_counts()
    col, out, small_s, small_host = small_batch_leg(dev, batches)
    small_launches = {"hist": K.hist, "stream_compact": K.stream_compact}
    small_cadence = cadence(folds0)
    _require(K.hist > 0, "hist launched on the small-batch leg")
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

    print("phase 4 config-3 leg (BASELINE config 3, with distinct batches)")
    batches = cm_leg_data(dev, gen)
    for collection in (True, False):  # warm-up: the first use of each PyTorch kernel
        cm_leg(dev, batches, collection)
    cm_total = CM_BATCHES * CM_ROWS
    K.hist = 0
    cm_launches = 0
    for collection, form in ((True, "MetricCollection (bench.py's _fused)"), (False, "standalone")):
        before = K.hist
        folds0 = fold_counts()
        mat, f1_v, cm_s = cm_leg(dev, batches, collection)
        form_cadence = cadence(folds0)
        launched = K.hist - before
        _require(launched > 0, f"hist launched on the config-3 leg ({form})")
        cm_ref = check_cm_leg(batches, mat, f1_v)
        print(f"  {form}: confusion matrix (equal to torch.bincount's) and macro F1 {f1_v:.8f} "
              f"(float64 from the matrix {cm_ref['f1']:.8f}) over {cm_total} predictions in "
              f"{cm_s:.6f} s (CUDA events): {cm_total / cm_s:.1f} preds/s; hist launches {launched}")
        print(f"  {form}: fold cadence: {cadence_text(form_cadence)}")
    info = cm_information(dev, batches, cm_ref)
    cm_launches = K.hist
    print(f"  macro precision {info['precision']:.8f} and recall {info['recall']:.8f} on the same "
          f"batches (information; float64 from the matrix {cm_ref['precision']:.8f}, "
          f"{cm_ref['recall']:.8f}); hist launches over the leg {cm_launches}")
    cm_keys = torch.cat([label * CM_CLASSES + pred for pred, label in batches])
    del batches, mat

    print(f"phase 4 recommendation-eval leg ({REC_BATCHES} x ({REC_TASKS}, {REC_ROWS}) logits, "
          f"{REC_CLICK_RATE:.0%} clicks, weights: NE, CTR, calibration and their windows of "
          f"{REC_WINDOW}; R2Score over {R2_BATCHES} x ({R2_ROWS}, {R2_OUTPUTS}))")
    batches = rec_leg_data(dev)
    rec_leg(dev, batches[:2])  # warm-up: the first use of each PyTorch kernel
    launched0 = (K.hist, K.segment_sum, K.stream_compact, K.topk_kernel)
    rec = rec_leg(dev, batches)
    rec_errs = check_rec_leg(rec, rec_reference(batches))
    del batches
    r2 = r2_leg(dev)
    launched = [a - b for a, b in zip((K.hist, K.segment_sum, K.stream_compact,
                                       K.topk_kernel), launched0)]
    print(f"  {rec['preds']} predictions in {rec['elapsed_s']:.6f} s (CUDA events; host "
          f"{rec['host_s']:.6f} s): Throughput {rec['rate']:.1f} preds/s; peak memory "
          f"{rec['peak_bytes'] / 2**30:.2f} GiB; windows hold {rec['windows']} batches")
    print(f"  NE {[round(v, 8) for v in rec['out']['ne'].tolist()]}, CTR "
          f"{[round(v, 8) for v in rec['out']['ctr'].tolist()]}, calibration "
          f"{[round(v, 8) for v in rec['out']['cal'].tolist()]}; largest relative error against "
          f"float64 by metric { {k: float(f'{v:.3e}') for k, v in rec_errs.items()} }")
    print(f"  fold cadence: {cadence_text(rec['cadence'])}; kernel launches (hist, segment_sum, "
          f"stream_compact, topk) {launched}: the leg runs elementwise sums, no hand kernel")
    print(f"  R2Score (uniform {r2['uniform']:.8f}) over {R2_BATCHES * R2_ROWS} x {R2_OUTPUTS} in "
          f"{r2['seconds']:.6f} s (CUDA events); largest relative error against float64 "
          f"{ {k: float(f'{v:.3e}') for k, v in r2['errs'].items()} }; fold cadence: "
          f"{cadence_text(r2['cadence'])}")

    print(f"phase 4 ImageNet-val curve leg ({CURVE_BATCHES} x ({CURVE_ROWS}, {CURVE_CLASSES}) "
          f"softmax scores)")
    batches = curve_leg_data(dev, gen)
    K.hist = 0
    K.stream_compact = 0
    K.segment_sum = 0
    folds0 = fold_counts()
    binned, curve_out, curve_s, curve_peak, curve_folds = curve_leg(dev, batches)
    curve_launches = {"hist": K.hist, "stream_compact": K.stream_compact,
                      "segment_sum": K.segment_sum}
    curve_cadence = cadence(folds0)
    _require(K.stream_compact >= 4 and K.segment_sum > 0,
             f"the curve leg launched stream_compact and segment_sum: {curve_launches}")
    worst = check_curve_leg(batches, binned, curve_out)
    points = check_exact_curve(batches)
    curve_total = CURVE_BATCHES * CURVE_ROWS
    print(f"  MulticlassAUROC macro {float(curve_out[0].mean()):.8f}, MulticlassAUPRC macro "
          f"{float(curve_out[1].mean()):.8f} (per class within {worst['auroc']:.3e} and "
          f"{worst['auprc']:.3e} of float64 numpy), binned counts equal numpy's, over "
          f"{curve_total} rows in {curve_s:.4f} s (CUDA events): {curve_total / curve_s:.1f} rows/s; "
          f"peak memory {curve_peak / 2**30:.2f} GiB (incl. {CURVE_BATCHES} resident batches)")
    print(f"  compactions ran on {curve_folds} flattened rows; launches {curve_launches}")
    print(f"  fold cadence: {cadence_text(curve_cadence)}")
    print(f"  multiclass_precision_recall_curve on the first {CURVE_ROWS} rows equals the CPU's "
          f"({points} thresholds over {CURVE_CLASSES} classes)")
    curve_fold = curve_fold_inputs(batches)

    print("phase 4 ImageNet-val curve leg, approximate twin (2^12 buckets)")
    approx_curve_leg(dev, batches[:1])  # warm-up
    K.segment_sum = 0
    with record_sketch_folds() as rec:
        ac_metrics, ac_out, ac_s, ac_peak = approx_curve_leg(dev, batches)
    approx_curve_launches = K.segment_sum
    sketch_launches["multiclass"] = rec.count(n=CURVE_ROWS * CURVE_CLASSES, d=2,
                                              segments=CURVE_CLASSES << MC_SKETCH_BITS)
    _require(sketch_launches["multiclass"] == 2 * CURVE_BATCHES,
             f"one multiclass sketch fold a batch a metric: {rec.shapes}")
    ac = check_approx_curve(ac_metrics, ac_out, curve_out[:2])
    print(f"  MulticlassAUROC and MulticlassAUPRC (approx=True) over {curve_total} rows in {ac_s:.4f} s "
          f"(CUDA events): {curve_total / ac_s:.1f} rows/s; peak memory {ac_peak[0] / 2**30:.2f} GiB "
          f"(incl. {CURVE_BATCHES} resident batches; the leg's own {ac_peak[1] / 2**30:.3f} GiB above "
          f"what was allocated at its start); the exact metrics with the binned curve: "
          f"{curve_total / curve_s:.1f} rows/s, {curve_peak / 2**30:.2f} GiB")
    print(f"  every class within its error bound of the exact value: AUROC largest |error| "
          f"{ac['auroc'][0]:.3e} (largest bound {ac['auroc'][1]:.3e}), AUPRC {ac['auprc'][0]:.3e} "
          f"({ac['auprc'][1]:.3e}); segment_sum launches {approx_curve_launches}")
    del batches, binned, curve_out, ac_metrics, ac_out
    torch.cuda.empty_cache()

    print("phase 4 top-k leg (BASELINE config 4)")
    batches = topk_leg_data(dev, gen)
    topk_leg(dev, batches)  # warm-up: the first use of each PyTorch kernel
    K.topk_kernel = 0
    folds0 = fold_counts()
    _, topk_v, topk_s, topk_peak = topk_leg(dev, batches)
    topk_launches = K.topk_kernel
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
    batches = retrieval_leg_data(dev)
    retrieval_launches = 0
    retrieval_values = {}
    for k in RETRIEVAL_KS:
        retrieval_leg(dev, batches, k)  # warm-up
        K.topk_kernel = 0
        folds0 = fold_counts()
        ndcg, value, seconds = retrieval_leg(dev, batches, k)
        launched = K.topk_kernel
        ndcg_cadence = cadence(folds0)
        retrieval_launches += launched
        _require(launched > 0 and np.isfinite(value), f"NDCG@{k} launched the kernel, finite")
        plain, plain_value, _ = retrieval_leg(dev, batches, k, topk_method="dense")
        _require(int(ndcg.num_valid) == int(plain.num_valid) and _close(value, plain_value),
                 f"NDCG@{k} {value} vs dense route {plain_value}")
        retrieval_values[k] = (value, int(ndcg.num_valid))
        n_rows = RETRIEVAL_BATCHES * RETRIEVAL_ROWS
        print(f"  NDCG@{k} {value:.8f} (dense route {plain_value:.8f}) over {n_rows} rows of "
              f"{RETRIEVAL_LABELS} labels in {seconds:.4f} s (CUDA events): {n_rows / seconds:.1f} "
              f"rows/s; topk launches {launched}")
        print(f"  fold cadence: {cadence_text(ndcg_cadence)}")
    del batches
    torch.cuda.empty_cache()

    print("phase 4 sliced leg (bench.py config11_sliced whole, with Mean and Max beside it)")
    data = sliced_leg_data(dev)
    n_rows = SLICED_BATCHES * SLICED_ROWS
    sliced_epoch(dev, data, *sliced_setup(dev, data))  # warm-up: first use of each kernel
    acc, agg = sliced_setup(dev, data)
    K.segment_sum = 0
    folds0 = fold_counts()
    with record_sketch_folds() as rec:
        results, sliced_s, sliced_wall, sliced_peak = sliced_epoch(dev, data, acc, agg)
    sliced_launches = K.segment_sum
    sliced_cadence = cadence(folds0)
    sketch_launches["sliced"] = rec.count(n=n_rows, segments=SLICED_COHORTS * SLICED_PLANES)
    _require(sliced_launches > 0 and sketch_launches["sliced"] == 1,
             f"segment_sum launched on the sliced leg, one sketch fold: {rec.shapes}")
    worst_mean = check_sliced_leg(data, acc.metrics["acc"], results)
    trap_err, mw_err, mw_bound, occupied = check_sliced_sketch(data, acc.metrics["auroc"], results)
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
    print(f"  per-cohort AUROC sketch counts equal np.bincount(rows * {SLICED_PLANES} + plane) "
          f"({occupied} occupied (cohort, bucket) pairs); AUROC within {trap_err:.3e} of the float64 "
          f"trapezoid; {SLICED_SAMPLE_COHORTS} sampled cohorts within their bounds of the exact "
          f"Mann-Whitney AUROC (largest |error| {mw_err:.3e}, largest bound {mw_bound:.3e})")
    print(f"  unsliced MetricCollections on identical rows: {plain_s:.4f} s "
          f"({n_rows / plain_s:.1f} rows/s); config11_sliced_ratio {plain_s / sliced_s:.4f} "
          f"(information; bench.py's target >= 0.5)")
    leg_rows = torch.from_numpy(acc.slice_table.lookup_rows(_sliced_batch(data, 1)[0])).to(dev)
    _, leg_scores, leg_targets = _sliced_batch(data, 1)
    window = slice(SLICED_ROWS, (SLICED_BATCHES + 1) * SLICED_ROWS)
    window_inputs = (torch.from_numpy(acc.slice_table.lookup_rows(data[0][window])).to(dev),
                     data[1][window], data[2][window])
    sliced_values = {"ids": results["acc"].slice_ids,
                     **{k: results[k]["values"].cpu().numpy() for k in ("acc", "auroc", "max")},
                     "mean": results["mean"]["values"].cpu().numpy().astype(np.float64)}
    want = sliced_want(acc, agg, results)
    del acc, agg, results
    torch.cuda.empty_cache()

    print(f"resilience phase (b): the sliced leg's collections saved after batch {RES_SLICED_SAVE}, "
          f"restored into fresh ones, batches {RES_SLICED_SAVE + 1}-{RES_SLICED_BATCHES} fed")
    rb = resilience_sliced(dev, data, want, res_root)
    shutil.rmtree(os.path.join(res_root, "sliced_acc"))
    shutil.rmtree(os.path.join(res_root, "sliced_agg"))
    del want
    torch.cuda.empty_cache()
    print(f"  (b) two checkpoints, {rb['bytes']} B, saved in {rb['save_s']:.4f} s "
          f"({_rate(rb['bytes'], rb['save_s'])}), restored in {rb['restore_s']:.4f} s "
          f"({_rate(rb['bytes'], rb['restore_s'])}) into capacity {rb['fresh']} (grown {rb['grown']}); "
          f"counts, sketch planes and maxima equal the uninterrupted leg's, means within "
          f"{rb['mean_rel']:.3e}; segment_sum launches {rb['launches']}")

    print(f"phase 4 sharded leg ({SHARD_RANKS} ranks on one card over gloo: the retrieval leg's "
          f"label axis and the sliced leg's cohorts split over them)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as shard_dir:
        shard_ranks = shard_leg(shard_dir)
        check_shard_leg(shard_ranks, shard_dir, retrieval_values, sliced_values, sliced_launches)
    for res in shard_ranks:
        r = res["rank"]
        for k in RETRIEVAL_KS:
            g = res["retrieval"][str(k)]
            print(f"  rank {r}: NDCG@{k} {g['value']:.8f} (one process {retrieval_values[k][0]:.8f}) "
                  f"over {RETRIEVAL_BATCHES} x ({RETRIEVAL_ROWS}, {SHARD_LABELS}) label tiles in "
                  f"{g['seconds']:.4f} s (host clock): "
                  f"{RETRIEVAL_BATCHES * RETRIEVAL_ROWS / g['seconds']:.1f} rows/s; topk launches "
                  f"{g['topk_launches']}; {g['collectives']} collectives, {g['collective_bytes']} "
                  f"bytes sent; fold cadence: {cadence_text(g['cadence'])}")
        g = res["row_topk"]
        print(f"  rank {r}: row-sharded top-k (k={RETRIEVAL_KS[-1]}) over its "
              f"{RETRIEVAL_ROWS // SHARD_RANKS} rows of each batch in {g['seconds']:.4f} s: topk "
              f"launches {g['topk_launches']}, {g['collectives']} collectives")
        g = res["sliced"]
        print(f"  rank {r}: config11 over its {SHARD_COHORTS} cohorts of {SLICED_COHORTS}: "
              f"{n_rows} rows in {g['seconds']:.4f} s (CUDA events; {g['wall_seconds']:.4f} s on "
              f"the host clock): {n_rows / g['seconds']:.1f} rows/s; segment_sum launches "
              f"{g['segment_sum_launches']}; {g['collectives']} collectives, "
              f"{g['collective_bytes']} bytes sent; peak memory {g['peak_bytes'] / 2**30:.2f} GiB; "
              f"fold cadence: {cadence_text(g['cadence'])}")
        print(f"  rank {r}: per-cohort counts and max equal numpy, means within "
              f"{g['worst_mean']:.3e}, sketch counts equal np.bincount ({g['occupied']} occupied "
              f"pairs), AUROC within {g['trap_err']:.3e} of the trapezoid, sampled cohorts within "
              f"their bounds (largest |error| {g['mw_err']:.3e}); values equal the one-process leg's")
        g = res["sharded_segment_sum"]
        print(f"  rank {r}: sharded segment sum over its half of the sliced window: "
              f"{g['seconds']:.4f} s, segment_sum launches {g['segment_sum_launches']}, "
              f"{g['collective_bytes']} bytes all-reduced")
    shard_launches = {
        "topk_label": sum(res["retrieval"][str(k)]["topk_launches"]
                          for res in shard_ranks for k in RETRIEVAL_KS),
        "topk_row": sum(res["row_topk"]["topk_launches"] for res in shard_ranks),
        # each rank's epoch: the accuracy and Mean folds, and the sketch fold
        "segment_sum_slice_tile": sum(res["sliced"]["segment_sum_launches"]
                                      - res["sliced"]["sketch_folds"] for res in shard_ranks),
        "segment_sum_sketch_slice_tile": sum(res["sliced"]["sketch_folds"] for res in shard_ranks),
        "sharded_segment_sum": sum(res["sharded_segment_sum"]["segment_sum_launches"]
                                   for res in shard_ranks),
    }

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
    od = check_dp_obs(ranks)
    for res in ranks:
        o = res["obs"]
        print(f"  rank {res['rank']}: obs.sync_snapshot(timeout_s=30): {o['seconds']:.4f} s, one round "
              f"of {o['buffer_bytes']} buffer bytes; {len(o['merged_counters'])} merged counters, "
              f"{len(o['merged_gauges'])} rank-labelled gauges, {o['merged_events']} timeline events")
    print(f"  (d) merged counters equal the sum of both ranks' local snapshots; rank 0's "
          f"MetricsServer: GET /metrics {od['metrics_bytes']} bytes equal to prometheus_text() "
          f"({od['metrics_type']}), GET /health {od['health']}")
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

    print(f"resilience phase (c): the kill drill ({DP_RANKS} ranks on one card over gloo, the "
          f"data-parallel leg's chunks; rank 1 killed entering round 3)")
    rc = resilience_drill(dev, res_root, counts, acc_ref, f1_ref, auroc_ref)
    r0 = rc["rank0"]
    print(f"  (c) rank 1 exited {DRILL_EXIT_CODE}; rank 0's second sync returned its local values in "
          f"{r0['elapsed_s']:.4f} s (deadline {DRILL_TIMEOUT_S} s), failures counted {r0['failures']}; "
          f"fault world {rc['fault_s']:.2f} s (processes included)")
    print(f"  (c) both pre-fault checkpoints restored on the card to the saved leaves "
          f"({', '.join(f'{x:.4f}' for x in rc['restore_s'])} s); restarted pair "
          f"{rc['restart_s']:.2f} s: synced accuracy {rc['restart'][0]['accuracy']:.8f}, f1_macro "
          f"{rc['restart'][0]['f1_macro']:.8f}, AUROC {rc['restart'][0]['auroc']:.8f} pass the "
          f"data-parallel leg's gate; launches {rc['launches']}")
    shutil.rmtree(res_root)

    print(f"phase 4 distributed-curves leg ({DIST_RANKS} ranks on one card over gloo, each "
          f"through a ShardedEvaluator: (a) {DP_CHUNKS // DIST_RANKS * HEADLINE_CHUNK} data-parallel "
          f"rows a rank, (b) the "
          f"ImageNet-val batches split {DIST_CURVE_SPLIT}, (c) approx=True on (a)'s rows, (d) "
          "the fallbacks, (e) (a) and (b) on the quantized routes; then the quantized sync)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as dist_dir:
        dist_ranks = dist_leg(dist_dir)
        dist_ref = dist_references(dev)
        check_dist_leg(dist_ranks, dist_dir, auroc_ref, dist_ref)
        q8_worst = check_dist_quantized(dev, dist_ranks, dist_dir)
    torch.cuda.empty_cache()
    for res in dist_ranks:
        r = res["rank"]
        for part, what in (("binary", "(a) BinaryAUROC+BinaryAUPRC"),
                           ("multiclass", "(b) MulticlassAUROC+MulticlassAUPRC per class"),
                           ("approx", "(c) BinaryAUROC(approx=True)")):
            g = res[part]
            print(f"  rank {r}: {what}: compute() {g['compute_seconds']:.4f} s on the dist route "
                  f"(routes {g['routes']}, gather rounds {g['gather_rounds']}; collectives [calls, "
                  f"bytes sent] {g['collectives']}; {g['exchange_send_bytes']} bytes into the "
                  f"exchange); gather route {g['gather']['compute_seconds']:.4f} s "
                  f"({g['gather']['rounds']} rounds, {g['gather']['collectives']}); launches "
                  f"{g['launches']}; updates {g['update_seconds']:.4f} s; peak memory "
                  f"{g['peak_bytes'] / 2**30:.2f} GiB")
            if g["largest_all_reduce"] is not None:
                nbytes, secs = g["largest_all_reduce"]
                local = g["compute_seconds"] - sum(g["collective_seconds"].values())
                print(f"  rank {r}: {what}: largest all-reduce (the splitter histogram) {nbytes} "
                      f"bytes in {secs:.4f} s; seconds by collective (between synchronisations) "
                      f"{ {k: round(v, 4) for k, v in g['collective_seconds'].items()} }, the rank's "
                      f"own work {local:.4f} s")
        for kind, g in res["fallback"].items():
            print(f"  rank {r}: (d) {kind}: routes {g['routes']}, {g['gather_rounds']} gather "
                  f"rounds, compute() {g['compute_seconds']:.4f} s, AUROC {g['values']['auroc'][0]:.8f} "
                  f"(one process {dist_ref['fallback'][kind]['auroc']:.8f})")
    for res in dist_ranks:
        r = res["rank"]
        for fam, what in (("binary", "(a)"), ("multiclass", "(b)")):
            raw = res[fam]
            print(f"  rank {r}: (e) {what} raw: compute() {raw['compute_seconds']:.4f} s; splitter "
                  f"all-reduce [bytes, s] {raw['largest_all_reduce']}; "
                  f"{raw['exchange_send_bytes']} bytes into the exchange")
            for mode in QUANT_MODES:
                g = res["quantized"][f"{fam}/{mode}"]
                calls = [g["collectives"][f][0] for f in ("all_reduce_sum", "all_gather_stacked",
                                                           "all_to_all_rows")]
                print(f"  rank {r}: (e) {what} {mode}: compute() {g['compute_seconds']:.4f} s; "
                      f"splitter rounds [bytes into the collectives, s] {g['splitter_rounds']}; "
                      f"{g['exchange_send_bytes']} bytes into the exchange; collective calls "
                      f"(all_reduce, all_gather, all_to_all) {calls} for two metrics; seconds by "
                      f"collective { {k: round(v, 4) for k, v in g['collective_seconds'].items()} }; "
                      f"peak memory {g['peak_bytes'] / 2**30:.2f} GiB")
        print(f"  rank {r}: (e) quantized scores bit-identical to raw {res['quantized']['bit_equal']}; "
              f"NaN scores fall back on int8 ({res['quantized']['nan/int8']['routes']}); sketch "
              f"counts under the int8 knob exact: {res['quantized']['sketch_equal']}")
        for quantize, what in (("False", "raw"), ("True", "quantized")):
            g = res["sync"][quantize]
            print(f"  rank {r}: sync {what}: {g['seconds']:.4f} s for the collection (confusion "
                  f"matrix 1000 x 1000, a binary sketch, calibration of {SYNC_CAL_TASKS} tasks); "
                  f"rounds [label, payload bytes, s] {g['rounds']}")
    print(f"  quantized sync: confusion matrix and sketch AUROC equal to the raw sync's; "
          f"calibration drift at most {q8_worst:.4f} of its bound max|block| / 254 a rank")
    r0 = dist_ranks[0]
    print(f"  (a) AUROC {r0['binary']['values']['auroc'][0]:.8f} (one process, uncompacted "
          f"{auroc_ref:.8f}), AUPRC {r0['binary']['values']['auprc'][0]:.8f} (one process "
          f"{dist_ref['auprc']:.8f}); (b) every class within rtol 1e-5; (c) sketch counts equal the "
          f"one-process approx metric's, AUROC {r0['approx']['values']['auroc'][0]:.8f}")
    dist_launches = {
        "hist_splitter": sum(res["binary"]["launches"]["hist"] + res["quantized"]["nan/int8"]["launches"]["hist"]
                             + sum(res["quantized"][f"binary/{m}"]["launches"]["hist"] for m in QUANT_MODES)
                             for res in dist_ranks),
        "segment_sum_splitter": sum(res["multiclass"]["launches"]["segment_sum"]
                                    + sum(res["quantized"][f"multiclass/{m}"]["launches"]["segment_sum"]
                                          for m in QUANT_MODES) for res in dist_ranks),
        "segment_sum_sketch": sum(res["approx"]["launches"]["segment_sum"] for res in dist_ranks),
        "stream_compact": sum(res["fallback"][k]["launches"]["stream_compact"] for res in dist_ranks
                              for k in res["fallback"])
        + sum(res["quantized"]["nan/int8"]["launches"]["stream_compact"] for res in dist_ranks),
    }
    sketch_launches["binary"] += dist_launches["segment_sum_sketch"]

    print("phase 5 kernel timings at the main path's shapes (obs off)")
    obs.disable()
    launches = {k: headline_launches[k] + macro_launches[k] + small_launches[k] + dp_launches[k]
                + curve_launches[k] for k in headline_launches}
    launches["hist"] += cm_launches + dist_launches["hist_splitter"]
    launches["stream_compact"] += dist_launches["stream_compact"]
    res_launches = {k: ra["launches"][k] + rc["launches"][k] for k in ("hist", "stream_compact")}
    for k, n in res_launches.items():
        launches[k] += n
    launches["topk"] = topk_launches + retrieval_launches
    timer = Timer(dev)
    rows = kernel_rows(dev, gen, timer, launches, errs, fold)
    by_leg = {"sliced": sliced_launches, "curves": curve_launches["segment_sum"],
              "approx_headline": approx_headline_launches, "approx_curves": approx_curve_launches,
              "dist_curves": dist_launches["segment_sum_splitter"] + dist_launches["segment_sum_sketch"],
              "resilience": rb["launches"]}
    rows.append(segment_sum_row(dev, timer, sum(by_leg.values()),
                                errs["segment_sum"], leg_rows, leg_scores, leg_targets, window_inputs))
    rows[-1]["launches_by_leg"] = by_leg
    shard = shard_rows(dev, gen, timer, shard_launches, errs, window_inputs)
    shard[-1]["all_reduce_seconds_by_rank"] = [res["sharded_segment_sum"]["seconds"]
                                               for res in shard_ranks]
    del window_inputs
    rows.append(hist_c2_row(dev, timer, cm_launches, cm_keys))
    rows.append(compact_rows_row(timer, curve_launches["stream_compact"], curve_fold))
    rows.extend(sketch_rows(timer, sketch_fold_inputs(dev, sketch_gen(dev)), sketch_launches,
                            errs["segment_sum_sketch"]))
    rows.extend(shard)
    rows.extend(dist_rows(dev, timer, dist_launches))
    del cm_keys, curve_fold
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
    print(f"  hist_c2: segment_sum on the same keys {rows[4]['segment_sum_ms']:.4f} ms")
    t = rows[3]["at_binned_window"]
    print(f"  segment_sum: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library "
          f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f}) at the binned curve's stacked "
          f"window, {t['rows']} int32 ones into {t['segments']} segments")
    fold_t = rows[5]["fold"]
    print(f"  per-class fold at {rows[5]['shape']}: compact_count_rows_fast {fold_t['fast_ms']:.4f} ms, "
          f"the batched two-sort {fold_t['two_sort_ms']:.4f} ms")
    print(f"  segment_sum launches by leg: {by_leg}")
    t = shard[0]["at_k10"]
    print(f"  topk_label_tile: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library "
          f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f}) at ({RETRIEVAL_ROWS}, {SHARD_LABELS}) "
          f"float32 label tile, k=10")
    print(f"  sharded leg launches: {shard_launches}; sharded segment sum's all_reduce by rank "
          f"(host clock, kernel included): {shard[-1]['all_reduce_seconds_by_rank']}")
    print(f"  resilience phase launches: hist {res_launches['hist']}, stream_compact "
          f"{res_launches['stream_compact']}, segment_sum {rb['launches']}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--dist-rank":
        sys.exit(dist_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if len(sys.argv) == 4 and sys.argv[1] == "--dp-rank":
        sys.exit(dp_worker(int(sys.argv[2]), sys.argv[3]))
    if len(sys.argv) == 6 and sys.argv[1] == "--drill-rank":
        sys.exit(drill_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]))
    if len(sys.argv) == 5 and sys.argv[1] == "--shard-rank":
        sys.exit(shard_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
