"""The spanned passes: the program's own spans, joined to the device trace.

The per-layer metrics that read the program's spans
(``evalbench/layer_metrics/{update_span_us,compute_span_ms,reset_span_ms,
fold_host_ms,compute_fn_host_ms,fold_device_ms,compute_fn_device_ms,
port_idle_ms,fold_calls_per_pass,hand_kernel_roofline}.py``) call
:func:`of`. Its first call in a run measures once, after every reading the
traced run took before (the window, the obs passes, the profiled passes and
the check are done, and the program is freed): the cell's inputs are made
again from the seed, a program is built and warmed, one pass runs with the
program's obs on (its first sights and cost captures), then whole passes
run with obs on for about ``HOST_SECONDS`` (the host's span times and the
counters, with no profiler to slow each op), and then for about
``harness.TRACE_SECONDS`` under ``torch.profiler`` (the device's time and
idle gaps). The obs ring is read and cleared after each pass, so that no
event is dropped (a pass whose ring dropped one makes the phase read
nothing).

The program's spans (``torcheval_tpu_torch.obs``) are each a registry span,
mirrored into the ring with its path and labels, and a profiler range of
the span's own name. The join:

* **Host**: span durations come from the ring of the passes without the
  profiler. A span's own name is its path less its ``parent`` label.
* **Device**: each kernel, copy and memset is put down to the innermost
  program range whose host interval holds its launch (the runtime call
  with the kernel's correlation id; else the host event its
  ``linked_correlation_id`` names), and through the range's ancestors to a
  phase: a fold (``deferred.operands``, ``deferred.fold/*``), a compute
  (``deferred.compute_fn/*``, ``metric.compute/*``), the rest of a
  ``collection.*`` span, or outside every collection span.
* **Idle**: each gap in the union of the device's intervals is named by
  the innermost program range at its middle.
* **Labels** (``member=``, ``shape=``): each range is matched to the ring
  span of the same own name, in order within the pass; the largest start
  gap between the two is the clock check (one clock: Unix ns).

A program without these spans (an older commit) reads ``None`` where the
span is missing. A fault in the phase is not caught: it fails the run, so
that a traced run reports a failed phase and not missing metrics.
"""

from __future__ import annotations

import gc
import json
import statistics
import sys
import threading
import time
import warnings
from bisect import bisect_right
from collections import defaultdict
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from evalbench.core import harness
from evalbench.core.profile import _label_at, innermost, merged

# the ring holds a whole pass: the largest pass records some thousands
RING_EVENTS = 1 << 20
# the passes whose spans give the host's times run this long before the
# profiled ones (``harness.TRACE_SECONDS``)
HOST_SECONDS = 1.0
PASS_RANGE = "evalbench.pass"
FOLD = ("deferred.operands", "deferred.fold/")
COMPUTE = ("deferred.compute_fn/", "metric.compute/")
COLLECTION = "collection."
RUNTIME = ("cuda_runtime", "cuda_driver")
TOP = 10

_UNSET = object()


def of(run) -> Optional[SimpleNamespace]:
    """The spanned passes of ``run``, measured on the first call."""
    got = getattr(run, "spans", _UNSET)
    if got is _UNSET:
        got = run.spans = measure(run)
    return got


def _own(event: Dict[str, Any]) -> str:
    parent = event["labels"].get("parent")
    return event["name"][len(parent) + 1:] if parent else event["name"]


def measure(run) -> Optional[SimpleNamespace]:
    """The phase (module doc) for ``run``'s cell, seed and device; its
    breakdown goes to stderr."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.obs import trace as ring

    cell, device = run.cell, run.device
    inputs = cell.inputs(run.seed, device)
    batches = cell.batches(inputs)
    program = harness.Program(cell, device)
    harness.run_pass(program, batches, device)
    capacity = ring.capacity()
    warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    dropped = 0

    def passes(seconds: float, one_pass) -> List[List[Dict[str, Any]]]:
        """Whole passes for about ``seconds``; each pass's ring events."""
        nonlocal dropped
        rings: List[List[Dict[str, Any]]] = []
        t = time.perf_counter()
        while len(rings) < harness.MAX_TRACE_PASSES and (
            not rings or time.perf_counter() - t < seconds
        ):
            one_pass()
            dropped += ring.dropped()
            rings.append(obs.timeline_events())
            ring.clear()
        return rings

    def ranged_pass() -> None:
        with torch.profiler.record_function(PASS_RANGE):
            harness.run_pass(program, batches, device, ranges=True)

    t0 = time.perf_counter()
    obs.reset()
    obs.set_timeline_capacity(RING_EVENTS)
    obs.enable()
    try:
        harness.run_pass(program, batches, device)  # first sights, cost captures
        obs.default_registry.reset()
        ring.clear()
        # the host's spans with no profiler in the way (it costs every op
        # some microseconds), then the device's under it
        host_rings = passes(HOST_SECONDS, lambda: harness.run_pass(program, batches, device))
        counters = dict(obs.snapshot()["counters"])
        with torch_profile(activities=activities) as prof:
            rings = passes(harness.TRACE_SECONDS, ranged_pass)
    finally:
        obs.disable()
        obs.reset()
        obs.set_timeline_capacity(capacity)
    del program, batches, inputs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if dropped:
        print(f"evalbench: the obs ring dropped {dropped} events; the spans read nothing",
              file=sys.stderr)
        return None
    out = join(normalize(prof.profiler.kineto_results.events()), rings, counters,
               threading.get_ident(), host_rings)
    if out is not None:
        out.phase_s = time.perf_counter() - t0
        _report(run, out)
    return out


def normalize(events) -> SimpleNamespace:
    """The profiler's events as plain tuples: the passes' and the program's
    ranges ``(start, end, name, thread)``, device intervals ``(start, end,
    name, correlation, linked correlation)``, and host start times by
    correlation id for runtime calls and for the other host events."""
    cuda = torch.autograd.DeviceType.CUDA
    out = SimpleNamespace(passes=[], ranges=[], device=[], runtime={}, host={})
    for e in events:
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        if e.device_type() == cuda:
            if not e.is_user_annotation() and not name.startswith("evalbench."):
                out.device.append((s, end, name, e.correlation_id(), e.linked_correlation_id()))
        elif kind in RUNTIME or (not kind and name.startswith("cu")):
            out.runtime[e.correlation_id()] = s
        else:
            # a range, the harness's or the program's (a user annotation,
            # or a RecordFunction named as the port names its spans, with a
            # "." or "/" and without the ops' "::"), or an op
            if name == PASS_RANGE:
                out.passes.append((s, end, name, e.start_thread_id()))
            elif (e.is_user_annotation() or _program_name(name)) and not name.startswith("evalbench."):
                out.ranges.append((s, end, name, e.start_thread_id()))
            out.host[e.correlation_id()] = s
    return out


def _program_name(name: str) -> bool:
    return "::" not in name and ("." in name or "/" in name)


def _parents(ranges: Sequence[Tuple[int, int, str, Any]]) -> List[int]:
    """Each range's parent index (-1 for none), for ranges of one thread
    sorted by (start, -end)."""
    out: List[int] = []
    stack: List[int] = []
    for i, (s, _, _, _) in enumerate(ranges):
        while stack and ranges[stack[-1]][1] <= s:
            stack.pop()
        out.append(stack[-1] if stack else -1)
        stack.append(i)
    return out


def _phase(name: str) -> Optional[str]:
    if name.startswith(FOLD):
        return "fold"
    if name.startswith(COMPUTE):
        return "compute"
    return None


def join(trace: SimpleNamespace, rings: List[List[Dict[str, Any]]], counters: Dict[str, float],
         thread: int, host_rings: Optional[List[List[Dict[str, Any]]]] = None
         ) -> Optional[SimpleNamespace]:
    """The spanned passes' readings (module doc); None without a pass.
    ``rings`` are the profiled passes' ring events, ``host_rings`` (else
    ``rings``) those of the passes that give the host's times and, with
    ``counters``, the counts a pass."""
    passes = sorted(trace.passes)
    n = len(passes)
    if not n or n != len(rings):
        return None
    pass_thread = passes[0][3]
    ranges = sorted((r for r in trace.ranges if r[3] == pass_thread), key=lambda r: (r[0], -r[1]))
    names = [r[2] for r in ranges]
    parent = _parents(ranges)
    # the innermost range at a time, by index
    segs = innermost([(r[0], r[1], i) for i, r in enumerate(ranges)])
    seg_starts = [a for a, _, _ in segs]

    def at(t: int) -> int:
        i = _label_at(segs, seg_starts, t)
        return -1 if i is None else i

    def own_spans(evs):
        return [e for e in evs if e["kind"] == "span" and e["tid"] == thread]

    # the ring's spans of each profiled pass, and of each host pass
    spans = [own_spans(evs) for evs in rings]
    host = [own_spans(evs) for evs in host_rings] if host_rings is not None else spans
    n_host = len(host)

    # ranges <-> ring spans, per pass and own name, in order: labels, clock
    pass_starts = [p[0] for p in passes]
    by_pass: List[Dict[str, List[int]]] = [defaultdict(list) for _ in range(n)]
    for i, r in enumerate(ranges):
        k = bisect_right(pass_starts, r[0]) - 1
        if k >= 0 and r[0] < passes[k][1]:
            by_pass[k][r[2]].append(i)
    labels: Dict[int, Dict[str, Any]] = {}
    gaps: List[int] = []  # ring start less range start, ns
    gap_at: List[Tuple[int, str, int]] = []  # (|gap|, name, pass)
    for k in range(n):
        own = defaultdict(list)
        for e in sorted(spans[k], key=lambda e: e["ts"]):
            own[_own(e)].append(e)
        for name, idx in by_pass[k].items():
            ring_spans = own.get(name, [])
            if len(ring_spans) != len(idx):
                continue  # a range under a transform has no span
            for i, e in zip(idx, ring_spans):
                labels[i] = e["labels"]
                gaps.append(round(e["ts"] * 1e9) - ranges[i][0])
                gap_at.append((abs(gaps[-1]), name, k))

    # flags of each range through its ancestors
    in_col = [False] * len(names)
    phase: List[Optional[int]] = [None] * len(names)  # the range that sets the phase
    for i, name in enumerate(names):
        p = parent[i]
        in_col[i] = name.startswith(COLLECTION) or (p >= 0 and in_col[p])
        phase[i] = phase[p] if p >= 0 and phase[p] is not None else (i if _phase(name) else None)

    # device time by launch
    w0, w1 = passes[0][0], passes[-1][1]
    shares: Dict[str, float] = defaultdict(float)
    by_member: Dict[Tuple[str, str, str], float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    fold_ns = compute_ns = 0
    unplaced = 0
    for s, e, name, corr, linked in trace.device:
        if e <= w0 or s >= w1:
            continue
        d = e - s
        by_name[name] += d
        t = trace.runtime.get(corr)
        if t is None:
            t = trace.host.get(linked)
        i = at(t) if t is not None else -1
        if t is None:
            unplaced += d
        if i < 0 or not in_col[i]:
            shares["outside/" + (names[i] if i >= 0 else "none")] += d
            continue
        j = phase[i]
        if j is None:
            shares["collection/" + names[i]] += d
            continue
        kind = _phase(names[j])
        if kind == "fold":
            fold_ns += d
        else:
            compute_ns += d
        shares[kind] += d
        lb = labels.get(j, {})
        by_member[(names[j], str(lb.get("member", lb.get("members", ""))), lb.get("shape", ""))] += d

    busy = merged((max(s, w0), min(e, w1)) for s, e, *_ in trace.device if e > w0 and s < w1)
    busy_ns = sum(b - a for a, b in busy)
    idle: Dict[str, float] = defaultdict(float)
    port_idle = 0
    prev = w0
    for a, b in [*busy, (w1, w1)]:
        if a > prev:
            i = at((prev + a) // 2)
            idle[names[i] if i >= 0 else "none"] += a - prev
            if i >= 0 and in_col[i]:
                port_idle += a - prev
        prev = max(prev, b)

    def per_pass(picks, exclude=()) -> Optional[List[float]]:
        """Seconds a pass in the spans whose own name ``picks`` takes (and
        with no ancestor that ``exclude`` names); None if none ran."""
        seen, out = False, []
        for evs in host:
            total = 0.0
            for e in evs:
                if picks(_own(e)) and not any(x in e["labels"].get("parent", "") for x in exclude):
                    total += e["dur"]
                    seen = True
            out.append(total)
        return out if seen else None

    host_member: Dict[Tuple[str, str, str], float] = defaultdict(float)
    for evs in host:
        for e in evs:
            own = _own(e)
            if _phase(own) or own.startswith(("collection.", "metric.")):
                lb = e["labels"]
                host_member[(own, str(lb.get("member", lb.get("members", ""))), lb.get("shape", ""))] += e["dur"]

    def counted(name: str) -> Optional[float]:
        total = sum(v for k, v in counters.items() if k == name or k.startswith(name + "{"))
        return total / n_host if any(k.startswith(name) for k in counters) else None

    has_device = bool(trace.device)
    has = set(names)
    return SimpleNamespace(
        passes=n,
        pass_ms=[(p[1] - p[0]) / 1e6 for p in passes],
        host_passes=n_host,
        update_us=[e["dur"] * 1e6 for evs in host for e in evs if e["name"] == "collection.update"],
        compute_ms=per_pass(lambda own: own == "collection.compute"),
        reset_ms=per_pass(lambda own: own == "collection.reset"),
        fold_host_ms=per_pass(lambda own: own.startswith(FOLD)),
        compute_fn_host_ms=(per_pass(lambda own: own.startswith(COMPUTE), exclude=COMPUTE)
                            if any(_own(e).startswith(COMPUTE[0]) for evs in host for e in evs)
                            else None),
        fold_device_ms=(fold_ns / n / 1e6 if has_device and any(x.startswith(FOLD) for x in has)
                        else None),
        compute_fn_device_ms=(compute_ns / n / 1e6
                              if has_device and any(x.startswith(COMPUTE[0]) for x in has) else None),
        port_idle_ms=(port_idle / n / 1e6 if has_device and any(x.startswith(COLLECTION) for x in has)
                      else None),
        fold_calls=counted("deferred.fold_calls"),
        launch_bytes=counted("obs.cost.launch_bytes"),
        by_name={k: v / 1e9 for k, v in by_name.items()},
        busy_s=busy_ns / 1e9,
        window_s=(w1 - w0) / 1e9,
        shares={k: v / busy_ns for k, v in shares.items()} if busy_ns else {},
        unplaced_s=unplaced / 1e9,
        idle={k: v / 1e9 for k, v in idle.items()},
        device_member={k: v / n / 1e6 for k, v in by_member.items()},
        host_member={k: v / n_host * 1e3 for k, v in host_member.items()},
        clock_gap_us=max(map(abs, gaps)) / 1e3 if gaps else None,
        largest_gaps=[[g / 1e3, name, k] for g, name, k in sorted(gap_at, reverse=True)[:8]],
        gap_quantiles_us=([g / 1e3 for g in statistics.quantiles(gaps, n=100)[::49]]
                          if len(gaps) > 1 else None),
        matched=len(labels),
        ranges=len(names),
    )


def _top(d: Dict[Any, float], k: int = TOP) -> List[List[Any]]:
    return [[" ".join(p for p in x if p) if isinstance(x, tuple) else x, v]
            for x, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]


def _report(run, s: SimpleNamespace) -> None:
    """The spanned passes' breakdown on stderr, one JSON object."""
    base = None
    if getattr(run, "trace", None) is not None and run.trace.passes:
        base = run.trace.window_s / run.trace.passes * 1e3
    spanned = statistics.median(s.pass_ms)
    print("evalbench: spanned " + json.dumps({
        "phase_s": s.phase_s,
        "host_passes": s.host_passes,
        "passes": s.passes,
        "pass_ms_median": spanned,
        "profiled_pass_ms": base,
        "spanned_over_profiled": spanned / base if base else None,
        "clock_gap_us_max": s.clock_gap_us,
        "clock_gap_us_p1_p50_p99": s.gap_quantiles_us,
        "largest_gaps_us_name_pass": s.largest_gaps,
        "ranges": s.ranges,
        "matched": s.matched,
        "busy_s": s.busy_s,
        "window_s": s.window_s,
        "unplaced_s": s.unplaced_s,
        "shares_of_busy": _top(s.shares, 20),
        "device_ms_per_pass": _top(s.device_member, 20),
        "host_ms_per_pass": _top(s.host_member, 30),
        "idle_s_by_range": _top(s.idle),
    }), file=sys.stderr)
