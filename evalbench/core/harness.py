"""One run of one cell: set-up, the measured window, the trace, the check.

A pass is what an evaluation loop does once per evaluation: ``reset()`` on
each collection, ``update()`` over every batch of the pass in order, then
``compute()`` with every value brought to the host. The window runs passes
back to back and ends with the first pass that ends after ``seconds``.
Set-up is everything before the window: imports, CUDA start-up, making the
inputs on the card from the seed, building the collections, and one warm
pass (which builds or loads the hand kernels and touches every shape of
the cell, the last partial batch included).

With ``trace`` the window times each ``update()`` and each pass's
``compute()`` on the host clock; after it, obs counts the launches of two
passes, and ``torch.profiler`` records whole passes for about two seconds.
The end-to-end metrics come from a run without ``trace``.

After the window the program is freed, and the values of a sample of the
window's passes (drawn from the seed) are held against the plain
reference (``evalbench/reference/``), computed in float64 from the same
inputs. Each number is printed beside its limit.
"""

from __future__ import annotations

import gc
import json
import math
import random
import sys
import time
import warnings
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

import torch

from evalbench.core import profile
from evalbench.core.spec import Spec

# passes whose values are held against the reference, drawn from the seed
SAMPLED_PASSES = 3
# obs counts launches over this many passes of the traced run
OBS_PASSES = 2
# the profiler records whole passes until this many seconds have passed
TRACE_SECONDS = 2.0
MAX_TRACE_PASSES = 64


class Cell:
    """A cell resolved from its files: its configuration, its batches, its
    metric suite and the plain references of its metrics. ``rows`` and
    ``batch_rows`` override the files' sizes (the CPU tests' small runs)."""

    def __init__(
        self,
        spec: Spec,
        name: str,
        *,
        rows: Optional[int] = None,
        batch_rows: Optional[int] = None,
    ) -> None:
        self.name = name
        self.workload = spec.workload(name)
        self.config = spec.config(self.workload["config"])
        self.rows = int(rows or self.config["rows_per_pass"])
        self.batch_rows = int(batch_rows or self.workload["batch_rows"])
        self.chips = int(self.workload.get("chips", 1))
        self.generator = spec.module("generators", self.config["generator"])
        self.collections = [
            (tuple(c["args"]), list(c["metrics"])) for c in self.config["collections"]
        ]
        self.metrics = [m for _, members in self.collections for m in members]
        self.references = {
            m["class"]: spec.module("reference", m["class"]) for m in self.metrics
        }

    def inputs(self, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
        """The whole pass's inputs, made on ``device`` from ``seed``."""
        return self.generator.make(seed, self.rows, device, self.config["generator_params"])

    def batches(self, inputs: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
        """The pass cut into batches of ``batch_rows`` rows (views)."""
        used = sorted({a for args, _ in self.collections for a in args})
        return [
            {a: inputs[a][start:start + self.batch_rows] for a in used}
            for start in range(0, self.rows, self.batch_rows)
        ]

    def input_bytes(self, inputs: Dict[str, torch.Tensor]) -> int:
        """The bytes handed to ``update()`` in one pass, each tensor once."""
        used = {a for args, _ in self.collections for a in args}
        return sum(int(inputs[a].nbytes) for a in used)


class Program:
    """The system under test: one ``MetricCollection`` of
    ``torcheval_tpu_torch`` per update signature, each metric built from
    its class name and keyword arguments in the configuration."""

    def __init__(self, cell: Cell, device: torch.device) -> None:
        from torcheval_tpu_torch import metrics as M

        self.collections = []
        for args, members in cell.collections:
            col = M.MetricCollection({
                m["key"]: getattr(M, m["class"])(**m["kwargs"], device=device)
                for m in members
            })
            self.collections.append((args, col))

    def reset(self) -> None:
        for _, col in self.collections:
            col.reset()

    def update(self, batch: Dict[str, torch.Tensor], clock: Optional[list] = None) -> None:
        for args, col in self.collections:
            if clock is None:
                col.update(*[batch[a] for a in args])
            else:
                t = time.perf_counter()
                col.update(*[batch[a] for a in args])
                clock.append(time.perf_counter() - t)

    def compute(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for _, col in self.collections:
            out.update(col.compute())
        return out


class ControlProgram:
    """The control: the plain reference in the program's place, computed
    in ``dtype`` (bfloat16, the precision below the configurations'
    float32) over the batches that the pass hands it."""

    def __init__(self, cell: Cell, device: torch.device, dtype: torch.dtype = torch.bfloat16) -> None:
        self.cell, self.dtype, self.seen = cell, dtype, []

    def reset(self) -> None:
        self.seen = []

    def update(self, batch: Dict[str, torch.Tensor], clock: Optional[list] = None) -> None:
        self.seen.append(batch)

    def compute(self) -> Dict[str, Any]:
        inputs = {k: torch.cat([b[k] for b in self.seen]) for k in self.seen[0]}
        return references(self.cell, inputs, self.dtype)


def to_host(values: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).detach().to("cpu") for k, v in values.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_pass(
    program,
    batches: List[Dict[str, torch.Tensor]],
    device: torch.device,
    *,
    update_clock: Optional[list] = None,
    compute_clock: Optional[list] = None,
    ranges: bool = False,
) -> Dict[str, torch.Tensor]:
    """One evaluation pass; returns its values on the host. ``ranges``
    marks the pass, its reset, updates and compute for the profiler."""
    rf = torch.profiler.record_function if ranges else None
    if rf:
        with rf("evalbench.reset"):
            program.reset()
        with rf("evalbench.update"):
            for b in batches:
                program.update(b, update_clock)
        with rf("evalbench.compute"):
            values = to_host(program.compute())
    else:
        program.reset()
        for b in batches:
            program.update(b, update_clock)
        t = time.perf_counter()
        values = to_host(program.compute())
        if compute_clock is not None:
            compute_clock.append(time.perf_counter() - t)
    _sync(device)
    return values


def references(cell: Cell, inputs: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every metric's value by its plain reference, computed in ``dtype``
    from the pass's inputs, on the host."""
    out = {}
    for args, members in cell.collections:
        a = [inputs[n] for n in args]
        for m in members:
            ref = cell.references[m["class"]].reference(a, m["kwargs"], dtype)
            out[m["key"]] = torch.as_tensor(ref).detach().to("cpu")
    return out


def gap(kind: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """``exact``: the number of entries that differ. ``rel``: the largest
    relative gap over the entries. A shape that differs, or a NaN, is an
    infinite gap."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    if kind == "exact":
        return float((got.to(torch.int64) != want.to(torch.int64)).sum())
    g, w = got.to(torch.float64), want.to(torch.float64)
    if g.numel() == 0:
        return 0.0
    d = (g - w).abs() / w.abs().clamp_min(1e-300)
    if bool(torch.isnan(d).any()):
        return math.inf
    return float(d.max())


def gaps(cell: Cell, values: Dict[str, torch.Tensor], refs: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {
        m["key"]: gap(cell.references[m["class"]].GAP, values[m["key"]], refs[m["key"]])
        if m["key"] in values else math.inf
        for m in cell.metrics
    }


class Reservoir:
    """A sample of ``k`` passes' values drawn from the seed."""

    def __init__(self, k: int, seed: int) -> None:
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item: Any) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def _quiet() -> None:
    gc.collect()
    gc.freeze()


def measure(
    cell: Cell,
    seed: int,
    seconds: float,
    trace: bool,
    device: torch.device,
    *,
    t0: float,
    program_factory: Optional[Callable] = None,
) -> SimpleNamespace:
    """Set-up, window, (trace), check; everything the readers read."""
    parts: Dict[str, float] = {}
    last = [t0]

    def lap(name: str) -> None:
        now = time.perf_counter()
        parts[name], last[0] = now - last[0], now

    lap("before_inputs")
    inputs = cell.inputs(seed, device)
    batches = cell.batches(inputs)
    _sync(device)
    lap("inputs")
    program = (program_factory or Program)(cell, device)
    lap("collections")
    run_pass(program, batches, device)  # the warm pass
    lap("warm_pass")
    _quiet()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    update_clock = [] if trace else None
    compute_clock = [] if trace else None
    sample = Reservoir(SAMPLED_PASSES, seed)
    pass_s: List[float] = []
    w0 = time.perf_counter()
    setup_s = w0 - t0
    while True:
        p0 = time.perf_counter()
        values = run_pass(program, batches, device,
                          update_clock=update_clock, compute_clock=compute_clock)
        p1 = time.perf_counter()
        pass_s.append(p1 - p0)
        sample.offer(values)
        if p1 - w0 >= seconds:
            break
    window_s = p1 - w0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    output_bytes = sum(int(v.nbytes) for v in values.values())

    obs_counters, traced = None, None
    if trace:
        obs_counters = _obs_passes(program, batches, device)
        traced = _profiled_passes(program, batches, device)

    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    refs = references(cell, inputs, torch.float64)
    checks: Dict[str, List[float]] = {}
    failed = 0
    for values in sample.items:
        g = gaps(cell, values, refs)
        bad = False
        for m in cell.metrics:
            key, limit = m["key"], float(m["limit"])
            prev = checks.get(key, [0.0, limit])[0]
            checks[key] = [max(prev, g[key]), limit]
            bad = bad or not g[key] <= limit
        failed += bad
    return SimpleNamespace(
        cell=cell,
        seed=seed,
        device=device,
        device_name=torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        rows_per_pass=cell.rows,
        passes=len(pass_s),
        pass_s=pass_s,
        window_s=window_s,
        setup_s=setup_s,
        setup_parts=parts,
        peak_bytes=peak,
        input_bytes=cell.input_bytes(inputs),
        output_bytes=output_bytes,
        update_s=update_clock,
        compute_s=compute_clock,
        obs_counters=obs_counters,
        obs_passes=OBS_PASSES,
        trace=traced,
        checks=checks,
        compared=len(sample.items),
        failed=failed,
        correct=failed == 0 and bool(sample.items),
    )


def _obs_passes(program, batches, device) -> Dict[str, float]:
    """The obs registry's counters over ``OBS_PASSES`` passes (obs is on
    for these passes only: it costs the host path a third or more)."""
    from torcheval_tpu_torch.obs import registry

    registry.reset()
    registry.enable()
    try:
        for _ in range(OBS_PASSES):
            run_pass(program, batches, device)
        counters = dict(registry.snapshot()["counters"])
    finally:
        registry.disable()
        registry.reset()
    return counters


def _profiled_passes(program, batches, device):
    """Whole passes under ``torch.profiler`` for about ``TRACE_SECONDS``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    # one profiling cycle: its warning about clearing events between cycles
    # does not apply
    warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    passes = 0
    with torch_profile(activities=activities) as prof:
        t = time.perf_counter()
        while passes < MAX_TRACE_PASSES and (passes == 0 or time.perf_counter() - t < TRACE_SECONDS):
            with torch.profiler.record_function("evalbench.pass"):
                run_pass(program, batches, device, ranges=True)
            passes += 1
    return profile.summarize(prof.profiler.kineto_results.events(), passes)


def result_line(run: SimpleNamespace, spec: Spec, trace: bool) -> Dict[str, Any]:
    """The contract's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, (``breakdown``) and, last, ``checks``."""
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_for(section, run.cell.name):
        reader = spec.module("layer_metrics" if trace else "end_to_end", m["name"])
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {
        "platform": "gpu" if run.device.type == "cuda" else run.device.type,
        "kind": run.device_name,
        "count": run.cell.chips,
        "memory_peak_bytes": run.peak_bytes,
    }
    line: Dict[str, Any] = {
        "correct": run.correct,
        "attempted": run.passes,
        "failed": run.failed,
        "metrics": metrics,
        "device": device,
    }
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = {
            "device_ops": run.trace.device_ops,
            "idle_gaps": run.trace.idle_gaps,
        }
    # an infinite gap (a value missing, of another shape, or NaN) is null
    line["checks"] = {
        k: {"gap": g if math.isfinite(g) else None, "limit": lim}
        for k, (g, lim) in run.checks.items()
    }
    return line


def print_checks(run: SimpleNamespace, stream=sys.stderr) -> None:
    """Each number compared beside its limit: the last lines on stderr."""
    print(f"evalbench: compared {run.compared} sampled passes of {run.passes}; "
          f"correct={run.correct}", file=stream)
    for key, (g, limit) in run.checks.items():
        verdict = "ok" if g <= limit else "FAIL"
        print(f"check {key}: gap {g!r} limit {limit!r} {verdict}", file=stream)
    stream.flush()


def emit(line: Dict[str, Any]) -> None:
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
