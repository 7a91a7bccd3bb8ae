#!/usr/bin/env python3
"""Where the time of one of the port's legs goes, on one CUDA device.

Run from the root of the repository:

    python3 scripts/profile_headline_torch.py [--leg headline|approx|small|topk|ndcg10|ndcg100|sliced|config3|config3_standalone|curves|curves_approx]

It builds one leg of ``chip_smoke.py`` with its data made on the card from
a seed: ``headline`` (the default: MulticlassAccuracy over 5 classes plus
BinaryAUROC with compaction_threshold = 6 * 2^24, 16 chunks of 2^24
predictions), ``approx`` (BinaryAUROC and BinaryAUPRC with ``approx=True`` and
Quantile(q=(0.5, 0.9, 0.99)) over the headline's binary logits), ``small``
(MulticlassAccuracy and macro MulticlassF1Score over
5 classes in one MetricCollection, 200 batches of 8192 rows: BASELINE
config 1's shapes), ``topk`` (TopKMultilabelAccuracy, k = 5, over 4 batches of
(8192, 10000) scores), ``ndcg10`` / ``ndcg100`` (NDCG at k = 10 or 100
over 4 batches of (64, 1,000,000) scores), ``sliced`` (the two sliced
collections, BinaryAccuracy with a 4-bit BinaryAUROC sketch and Mean with
Max, over 1,000,000 cohorts, 16 batches of 1,048,576 rows after a
registration batch that is not profiled), ``config3`` /
``config3_standalone`` (MulticlassConfusionMatrix(1000) and macro
MulticlassF1Score over 13 batches of 100,000 int32 predictions, in one
MetricCollection or standalone: BASELINE config 3) or ``curves``
(MulticlassAUROC and MulticlassAUPRC compacting every 20,000 rows and
MulticlassBinnedPrecisionRecallCurve over 5 batches of (10,000, 1000)
softmax scores: the ImageNet-1k validation set's size) or ``curves_approx``
(MulticlassAUROC and MulticlassAUPRC with ``approx=True``, 2^12 buckets, on
the same batches). It runs the leg once to warm up,
then once under ``torch.profiler``, and prints the wall time of both runs,
the device's busy time (the union of the intervals in which a kernel, copy
or memset ran) and idle share over the profiled run, and the device time by
kernel name (top 25). ``--runs N`` then times N more runs without the
profiler and prints each and their median: the way to compare two trees'
packages in turns on one leg. Exits non-zero without a CUDA device or when
the profiler records no device activity.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals: concurrent
    kernels count once."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _leg(cs, name, dev, gen):
    """``(prepare, run, count, unit)``: ``prepare()`` sets up one run
    outside the profiled region, ``run()`` drives the leg once and returns
    ``(seconds, values)``; ``count`` units make one run."""
    if name == "sliced":
        data = cs.sliced_leg_data(dev, gen)
        cols = []

        def prepare():
            cols[:] = cs.sliced_setup(dev, data)

        def run():
            results, seconds, _, _ = cs.sliced_epoch(dev, data, *cols)
            return seconds, (float(results["acc"]["values"].mean()),)

        return prepare, run, cs.SLICED_BATCHES * cs.SLICED_ROWS, "rows"
    run, count, unit = _plain_leg(cs, name, dev, gen)
    return (lambda: None), run, count, unit


def _plain_leg(cs, name, dev, gen):
    if name == "headline":
        chunks = cs.headline_data(dev, gen)

        def run():
            _, acc_v, auroc_v, seconds, _, _ = cs.headline_leg(dev, chunks)
            return seconds, (acc_v, auroc_v)

        return run, cs.HEADLINE_CHUNKS * cs.HEADLINE_CHUNK, "preds"
    if name == "approx":
        chunks = cs.headline_data(dev, gen)

        def run():
            _, values, seconds, _, _ = cs.approx_headline_leg(dev, chunks)
            return seconds, values[:2]

        return run, cs.HEADLINE_CHUNKS * cs.HEADLINE_CHUNK, "preds"
    if name == "curves_approx":
        batches = cs.curve_leg_data(dev, gen)

        def run():
            _, out, seconds, _ = cs.approx_curve_leg(dev, batches)
            return seconds, (float(out[0].mean()), float(out[1].mean()))

        return run, cs.CURVE_BATCHES * cs.CURVE_ROWS, "rows"
    if name == "small":
        batches = cs.small_batch_data(dev, gen)

        def run():
            _, out, seconds, _ = cs.small_batch_leg(dev, batches)
            return seconds, (float(out["accuracy"]), float(out["f1_macro"]))

        return run, cs.SMALL_BATCHES * cs.SMALL_ROWS, "rows"
    if name == "topk":
        batches = cs.topk_leg_data(dev, gen)

        def run():
            _, value, seconds, _ = cs.topk_leg(dev, batches)
            return seconds, (value,)

        return run, cs.TOPK_BATCHES * cs.TOPK_ROWS, "rows"
    if name in ("config3", "config3_standalone"):
        batches = cs.cm_leg_data(dev, gen)

        def run():
            _, f1_v, seconds = cs.cm_leg(dev, batches, name == "config3")
            return seconds, (f1_v,)

        return run, cs.CM_BATCHES * cs.CM_ROWS, "preds"
    if name == "curves":
        batches = cs.curve_leg_data(dev, gen)

        def run():
            _, out, seconds, _, _ = cs.curve_leg(dev, batches)
            return seconds, (float(out[0].mean()), float(out[1].mean()))

        return run, cs.CURVE_BATCHES * cs.CURVE_ROWS, "rows"
    k = int(name[len("ndcg"):])
    batches = cs.retrieval_leg_data(dev, gen)

    def run():
        _, value, seconds = cs.retrieval_leg(dev, batches, k)
        return seconds, (value,)

    return run, cs.RETRIEVAL_BATCHES * cs.RETRIEVAL_ROWS, "rows"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--leg", default="headline",
                        choices=("headline", "approx", "small", "topk", "ndcg10", "ndcg100",
                                 "sliced", "config3", "config3_standalone", "curves",
                                 "curves_approx"))
    parser.add_argument("--runs", type=int, default=0, help="timed runs after the profiled one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_headline_torch: no CUDA device.", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    prepare, run, total, unit = _leg(cs, args.leg, dev, gen)
    prepare()
    warm_s, values = run()
    print(f"{args.leg} warm-up run: {warm_s:.4f} s, {total / warm_s:.1f} {unit}/s "
          f"(values {values})")
    prepare()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_s, _ = run()
    print(f"profiled run: {run_s:.4f} s, {total / run_s:.1f} {unit}/s")
    # device-side events only (kernels, copies, memsets): the aten:: rows of
    # key_averages() repeat their kernels' time
    device = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0
    ]
    if not device:
        print("the profiler recorded no device events", file=sys.stderr)
        return 1
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in device)
    print(f"device busy {busy_us / 1e3:.3f} ms of {run_s * 1e3:.3f} ms wall: "
          f"idle share {1 - busy_us / 1e6 / run_s:.4f}")
    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    summed = sum(us for us, _ in by_name.values())
    print(f"{'device ms':>10} {'share':>7} {'calls':>6}  kernel")
    for name, (us, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"{us / 1e3:10.3f} {us / summed:7.4f} {calls:6d}  {name[:90]}")
    times = []
    for _ in range(args.runs):
        prepare()
        times.append(run()[0])
    if times:
        print("timed runs (s): " + json.dumps(times))
        print(f"median {sorted(times)[len(times) // 2]:.6f} s, "
              f"{total / sorted(times)[len(times) // 2]:.1f} {unit}/s")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
