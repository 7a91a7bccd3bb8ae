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
   path's shapes and at edge cases;
3. headline leg: ``MulticlassAccuracy(num_classes=5)`` and
   ``BinaryAUROC(compaction_threshold=6 * 2**24)`` over 16 chunks of 2^24
   predictions, checked against an uncompacted ``BinaryAUROC`` and a direct
   count, plus a small stream checked against float64 numpy references;
4. macro leg: ``MulticlassAccuracy(average="macro", num_classes=1000)`` over
   8 chunks of 2^22 rows, checked against the plain histogram;
   top-k leg: ``TopKMultilabelAccuracy(k=5, criteria="contain")`` over 4
   batches of (8192, 10000) scores, every criterion's counts checked
   against the plain top-k and the first 64 rows against a float64 numpy
   reference;
   retrieval leg: ``NDCG(k=10)`` and ``NDCG(k=100)`` over 4 batches of
   (64, 1,000,000) scores, checked against the dense (sorting) route;
5. one JSON line per the kernels: launches on the main path (phases 3 and
   4), time per launch, the plain version's and a library call's time, and
   the least time the card could take (its bound).

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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
TARGET_DENSITY = 1e-3
CRITERIA = ("exact_match", "hamming", "overlap", "contain", "belong")
# H100 SXM device-memory rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
RTOL, ATOL = 1e-5, 1e-8
L2_FLUSH_BYTES = 256 << 20


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= ATOL + RTOL * abs(b)


class Timer:
    """Median CUDA-event time of ``fn`` per call, with L2 flushed before each."""

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
    from torcheval_tpu_torch.ops.hist import hist, hist_plain

    worst = 0
    for n, c in ((HEADLINE_CHUNK, HEADLINE_CLASSES), (MACRO_CHUNK, MACRO_CLASSES), (1 << 20, 20000)):
        for dtype in (torch.int32, torch.int64):
            labels = torch.randint(-3, c + 3, (n,), generator=gen, device=dev, dtype=dtype)
            got, want = hist(labels, c), hist_plain(labels, c)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want).abs().max())
            worst = max(worst, err)
            _require(err == 0 and int(got.sum()) == int(((labels >= 0) & (labels < c)).sum()),
                     f"hist n={n} C={c} {dtype}")
            print(f"  hist n={n} C={c} {str(dtype)[6:]}: exact")
    return float(worst)


def _special_scores(n, dev, gen):
    s = torch.rand(n, generator=gen, device=dev)
    idx = torch.randint(0, n, (6, max(n // 1000, 1)), generator=gen, device=dev)
    for row, v in zip(idx, (float("nan"), float("inf"), float("-inf"), -0.0, 0.0, float("nan"))):
        s[row] = v
    return s


def check_compaction(dev, gen):
    from torcheval_tpu_torch.ops.stream_compact import (
        compact_summary_rows,
        compact_summary_rows_plain,
    )

    worst = 0
    for n in (THRESHOLD, THRESHOLD - 12345):
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
        ("ideal ranking 64x1000000 k=100", (rand(RETRIEVAL_ROWS, RETRIEVAL_LABELS) < TARGET_DENSITY).float(), 100),
        ("all equal", torch.full((256, 10_000), 0.5, device=dev), 128),
        ("heavy ties", ties(1024, 10_000), 128),
        ("+-inf, +-0.0, +-NaN", special, 64),
        ("ragged L=12345 k=1", rand(300, 12345), 1),
        ("L=1025 k=128", ties(500, 1025), 128),
        ("k=L=128", ties(500, 128), 128),
        ("k=L=100", rand(500, 100), 100),
    ]


def check_topk(dev, gen):
    from torcheval_tpu_torch.ops.topk import topk_kernel, topk_kernel_plain

    worst = 0.0
    for name, x, k in _topk_cases(dev, gen):
        v, i = topk_kernel(x, k)
        pv, pi = topk_kernel_plain(x, k)
        torch.cuda.synchronize()
        _require(torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi),
                 f"topk {name}")
        both = torch.isfinite(v) & torch.isfinite(pv)
        worst = max(worst, float((v[both] - pv[both]).abs().max()) if bool(both.any()) else 0.0)
        print(f"  topk {name} {tuple(x.shape)} k={k}: bit-equal values and indices")
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
        _require(int(m.num_correct) == correct and int(m.num_total) == total,
                 f"top-k {criteria} counts {int(m.num_correct)}/{int(m.num_total)} vs plain {correct}/{total}")
        got = float(topk_multilabel_accuracy(head_s, head_t, criteria=criteria, k=TOPK_K))
        want = _numpy_topk_accuracy(np_s, np_t, criteria)
        _require(_close(got, want), f"top-k {criteria} first 64 rows {got} vs numpy {want}")
        print(f"  {criteria}: {int(m.num_correct)}/{int(m.num_total)} equal to the plain top-k; "
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
            "topk": check_topk(dev, gen)}
    check_compact_counts(dev, gen, fold_scores, fold_t)
    del fold_scores, fold_t
    torch.cuda.synchronize()

    print("phase 3 headline leg")
    hist.launches = 0
    stream_compact.launches = 0
    acc, acc_v, auroc_v, seconds, host_seconds, peak = headline_leg(dev, chunks)
    headline_launches = {"hist": hist.launches, "stream_compact": stream_compact.launches}
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
    small_reference_check(dev)
    del chunks, acc
    torch.cuda.empty_cache()

    print("phase 4 macro leg")
    hist.launches = 0
    stream_compact.launches = 0
    macro_v, update_ms = macro_leg(dev, gen)
    macro_launches = {"hist": hist.launches, "stream_compact": stream_compact.launches}
    _require(hist.launches > 0, "hist launched on the macro leg")
    macro_total = MACRO_CHUNKS * MACRO_CHUNK
    print(f"  macro accuracy {macro_v:.8f} over {macro_total} rows (counts equal the plain "
          f"histogram); update time {update_ms:.3f} ms: {macro_total / update_ms * 1e3:.1f} "
          f"preds/s; launches {macro_launches}")

    print("phase 4 top-k leg (BASELINE config 4)")
    batches = topk_leg_data(dev, gen)
    topk_leg(dev, batches)  # warm-up: the first use of each PyTorch kernel
    topk_kernel.launches = 0
    _, topk_v, topk_s, topk_peak = topk_leg(dev, batches)
    topk_launches = topk_kernel.launches
    _require(topk_launches > 0, "topk launched on the top-k leg")
    n_rows = TOPK_BATCHES * TOPK_ROWS
    print(f"  contain accuracy {topk_v:.8f} over {n_rows} rows of {TOPK_LABELS} labels in "
          f"{topk_s:.4f} s (CUDA events): {n_rows / topk_s:.1f} rows/s; topk launches "
          f"{topk_launches}; peak memory {topk_peak / 2**30:.2f} GiB (incl. {TOPK_BATCHES} "
          f"resident batches)")
    check_topk_leg(dev, batches)
    del batches
    torch.cuda.empty_cache()

    print("phase 4 retrieval leg (BASELINE config 6)")
    batches = retrieval_leg_data(dev, gen)
    retrieval_launches = 0
    for k in RETRIEVAL_KS:
        retrieval_leg(dev, batches, k)  # warm-up
        topk_kernel.launches = 0
        ndcg, value, seconds = retrieval_leg(dev, batches, k)
        launched = topk_kernel.launches
        retrieval_launches += launched
        _require(launched > 0 and np.isfinite(value), f"NDCG@{k} launched the kernel, finite")
        plain, plain_value, _ = retrieval_leg(dev, batches, k, topk_method="dense")
        _require(int(ndcg.num_valid) == int(plain.num_valid) and _close(value, plain_value),
                 f"NDCG@{k} {value} vs dense route {plain_value}")
        n_rows = RETRIEVAL_BATCHES * RETRIEVAL_ROWS
        print(f"  NDCG@{k} {value:.8f} (dense route {plain_value:.8f}) over {n_rows} rows of "
              f"{RETRIEVAL_LABELS} labels in {seconds:.4f} s (CUDA events): {n_rows / seconds:.1f} "
              f"rows/s; topk launches {launched}")
    del batches
    torch.cuda.empty_cache()

    print("phase 5 kernel timings at the main path's shapes")
    launches = {k: headline_launches[k] + macro_launches[k] for k in headline_launches}
    launches["topk"] = topk_launches + retrieval_launches
    rows = kernel_rows(dev, gen, Timer(dev), launches, errs, fold)
    torch.cuda.synchronize()
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f}) at {r['shape']}")
    big = rows[-1]["at_64x1000000_k100"]
    print(f"  topk: {big['ms']:.4f} ms (plain {big['plain_ms']:.4f}, library "
          f"{big['library_ms']:.4f}, bound {big['bound_ms']:.4f}) at (64, 1000000) float32, k=100")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
