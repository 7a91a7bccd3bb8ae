"""The reduction of a ``torch.profiler`` trace to device time and idle time.

The device is busy while a kernel, a copy or a memset runs on it: the
union of those intervals, so that concurrent work counts once (the
arithmetic of the port's ``scripts/profile_headline_torch.py``
``_union_us``). The traced window runs from the start of the first
``evalbench.pass`` range to the end of the last. Each idle gap is named by
what the host was doing at its middle: the innermost harness range
(``evalbench.reset``, ``.update``, ``.compute``) and the innermost
operation on the host's main thread (``python`` where none ran).
"""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict
from types import SimpleNamespace
from typing import Iterable, List, Optional, Sequence, Tuple

import torch

RANGE_PREFIX = "evalbench."
TOP = 10
NAME_CHARS = 120

Interval = Tuple[int, int, str]


def merged(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union as sorted disjoint intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def innermost(intervals: Sequence[Interval]) -> List[Interval]:
    """Nested intervals of one thread as disjoint segments, each named by
    the innermost interval that covers it (uncovered time is left out)."""
    segs: List[Interval] = []
    stack: List[Tuple[int, str]] = []
    last = None

    def emit(upto: int) -> None:
        nonlocal last
        if stack and last is not None and upto > last:
            segs.append((last, upto, stack[-1][1]))
        last = upto

    for s, e, name in sorted(intervals, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            emit(stack[-1][0])
            stack.pop()
        emit(s)
        if stack:
            e = min(e, stack[-1][0])  # keep the nesting
        stack.append((e, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    return segs


def _label_at(segs: List[Interval], starts: List[int], t: int) -> Optional[str]:
    i = bisect_right(starts, t) - 1
    if i >= 0 and segs[i][1] > t:
        return segs[i][2]
    return None


def summarize(events, passes: int) -> Optional[SimpleNamespace]:
    """Device busy and idle time, device time by operation name, and idle
    time by host activity, over the traced window. None when no pass range
    was recorded."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges, host, device = [], [], []
    pass_thread = None
    for e in events:
        name = e.name()
        s = e.start_ns()
        iv = (s, s + e.duration_ns(), name)
        if e.device_type() == cuda:
            if not name.startswith(RANGE_PREFIX) and not e.is_user_annotation():
                device.append(iv)
        elif name.startswith(RANGE_PREFIX):
            ranges.append(iv)
            if name == RANGE_PREFIX + "pass":
                pass_thread = e.start_thread_id()
        else:
            host.append((iv, e.start_thread_id()))
    pass_ranges = [r for r in ranges if r[2] == RANGE_PREFIX + "pass"]
    if not pass_ranges:
        return None
    w0 = min(r[0] for r in pass_ranges)
    w1 = max(r[1] for r in pass_ranges)
    clipped = [(max(a, w0), min(b, w1), n) for a, b, n in device if b > w0 and a < w1]
    busy = merged((a, b) for a, b, _ in clipped)
    busy_ns = sum(b - a for a, b in busy)

    by_name = defaultdict(int)
    for a, b, n in clipped:
        by_name[n] += b - a
    device_ops = [
        [n[:NAME_CHARS], ns / 1e9]
        for n, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    ]

    range_segs = innermost([r for r in ranges if r[2] != RANGE_PREFIX + "pass"])
    host_segs = innermost([iv for iv, tid in host if tid == pass_thread])
    range_starts = [s[0] for s in range_segs]
    host_starts = [s[0] for s in host_segs]
    idle = defaultdict(int)
    prev = w0
    for a, b in [*busy, (w1, w1)]:
        if a > prev:
            mid = (prev + a) // 2
            where = _label_at(range_segs, range_starts, mid) or "evalbench.between"
            what = _label_at(host_segs, host_starts, mid) or "python"
            idle[f"{where[len(RANGE_PREFIX):]}/{what}"] += a - prev
        prev = max(prev, b)
    idle_gaps = [
        [n[:NAME_CHARS], ns / 1e9]
        for n, ns in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    ]
    return SimpleNamespace(
        passes=passes,
        window_s=(w1 - w0) / 1e9,
        busy_s=busy_ns / 1e9,
        by_name={n: ns / 1e9 for n, ns in by_name.items()},
        device_ops=device_ops,
        idle_gaps=idle_gaps,
    )
