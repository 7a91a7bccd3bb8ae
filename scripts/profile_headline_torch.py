#!/usr/bin/env python3
"""Where the time of one of the port's legs goes, on one CUDA device.

Run from the root of the repository:

    python3 scripts/profile_headline_torch.py [--leg headline|topk|ndcg10|ndcg100]

It builds one leg of ``chip_smoke.py`` with its data made on the card from
a seed: ``headline`` (the default: MulticlassAccuracy over 5 classes plus
BinaryAUROC with compaction_threshold = 6 * 2^24, 16 chunks of 2^24
predictions), ``topk`` (TopKMultilabelAccuracy, k = 5, over 4 batches of
(8192, 10000) scores) or ``ndcg10`` / ``ndcg100`` (NDCG at k = 10 or 100
over 4 batches of (64, 1,000,000) scores). It runs the leg once to warm up,
then once under ``torch.profiler``, and prints the wall time of both runs,
the device's busy time (the union of the intervals in which a kernel, copy
or memset ran) and idle share over the profiled run, and the device time by
kernel name (top 25). Exits non-zero without a CUDA device or when the
profiler records no device activity.
"""

from __future__ import annotations

import argparse
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
    """``(run, count, unit)``: ``run()`` drives the leg once and returns
    ``(seconds, values)``; ``count`` units make one run."""
    if name == "headline":
        chunks = cs.headline_data(dev, gen)

        def run():
            _, acc_v, auroc_v, seconds, _, _ = cs.headline_leg(dev, chunks)
            return seconds, (acc_v, auroc_v)

        return run, cs.HEADLINE_CHUNKS * cs.HEADLINE_CHUNK, "preds"
    if name == "topk":
        batches = cs.topk_leg_data(dev, gen)

        def run():
            _, value, seconds, _ = cs.topk_leg(dev, batches)
            return seconds, (value,)

        return run, cs.TOPK_BATCHES * cs.TOPK_ROWS, "rows"
    k = int(name[len("ndcg"):])
    batches = cs.retrieval_leg_data(dev, gen)

    def run():
        _, value, seconds = cs.retrieval_leg(dev, batches, k)
        return seconds, (value,)

    return run, cs.RETRIEVAL_BATCHES * cs.RETRIEVAL_ROWS, "rows"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--leg", choices=("headline", "topk", "ndcg10", "ndcg100"),
                        default="headline")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_headline_torch: no CUDA device.", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    run, total, unit = _leg(cs, args.leg, dev, gen)
    warm_s, values = run()
    print(f"{args.leg} warm-up run: {warm_s:.4f} s, {total / warm_s:.1f} {unit}/s "
          f"(values {values})")
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
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
