"""The spanned passes (``evalbench/core/spans.py``): a CPU ``--trace 1``
run of each cell prints the metrics that the program's spans and counters
give there; the join puts device time, idle time and labels where they
belong on a trace made by hand; a program without the spans reads
``None``, and a fault in the phase fails the read. The card's run, which prints every new metric,
carries the ``cuda`` marker."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from evalbench.core import harness, spans
from evalbench.core.spec import ROOT, Spec
from evalbench.tests.conftest import small_run

CELLS = ["criteo1tb_ctr_eval.whole", "imagenet1k_val_eval.b256", "imagenet1k_val_eval.whole"]
HOST = ["update_span_us", "compute_span_ms", "reset_span_ms", "fold_host_ms", "compute_fn_host_ms",
        "fold_calls_per_pass"]
DEVICE = ["fold_device_ms", "compute_fn_device_ms", "port_idle_ms"]


def _name(base, cell):
    return base + (".device_bound" if cell.startswith("criteo") else "")


@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_trace_run_prints_the_span_metrics(cell):
    run = small_run(cell, trace=True)
    line = harness.result_line(run, Spec(), True)
    got = line["metrics"]
    for base in HOST:
        assert got[_name(base, cell)]["value"] > 0, base
    # no device on the CPU: the device-timed ones are left out
    for base in DEVICE + ["hand_kernel_roofline"]:
        assert _name(base, cell) not in got
    s = run.spans
    assert s.passes >= 1 and s.matched == s.ranges > 0
    # the fold calls: one a member (concatenated), or one a batch (ragged)
    want = {"criteo1tb_ctr_eval.whole": 3, "imagenet1k_val_eval.whole": 4,
            "imagenet1k_val_eval.b256": 2 * 8 + 2}[cell]
    assert got[_name("fold_calls_per_pass", cell)]["value"] == want
    # the window's folds and computes lie inside compute()
    assert got[_name("fold_host_ms", cell)]["value"] < got[_name("compute_span_ms", cell)]["value"]


def _event(name, t0_ns, dur_ns, parent=None, **labels):
    if parent:
        labels["parent"] = parent
    path = f"{parent}/{name}" if parent else name
    return {"ts": t0_ns / 1e9, "dur": dur_ns / 1e9, "name": path, "kind": "span",
            "labels": labels, "tid": 7}


def _hand_trace():
    """One pass (0-1000 ns): an update (10-90), a compute (100-900) with a
    window step (150-600) holding a fold (200-300) and a terminal compute
    (400-500), and an eager member's compute (650-850)."""
    w = "collection.compute/jit/deferred.window_step"
    rng = [(10, 90, "collection.update"), (100, 900, "collection.compute"),
           (150, 600, "jit/deferred.window_step"), (200, 300, "deferred.fold/Acc"),
           (400, 500, "deferred.compute_fn/Acc"), (650, 850, "metric.compute/AUROC")]
    trace = SimpleNamespace(
        passes=[(0, 1000, "evalbench.pass", 1)],
        ranges=[(s, e, n, 1) for s, e, n in rng],
        # (start, end, name, correlation, linked): launched at 50, 250,
        # 450, 700 and 950 (after the collection's spans)
        device=[(60, 80, "k_update", 1, 0), (260, 400, "k_fold", 2, 0), (460, 520, "k_fn", 3, 0),
                (710, 760, "k_auroc", 4, 0), (955, 990, "k_after", 5, 0)],
        runtime={1: 50, 2: 250, 3: 450, 4: 700, 5: 950},
        host={},
    )
    ring = [[
        _event("collection.update", 12, 76),
        _event("deferred.fold/Acc", 203, 95, parent=w, member="top1", shape="ragged"),
        _event("deferred.compute_fn/Acc", 401, 98, parent=w, member="top1"),
        _event("jit/deferred.window_step", 151, 448, parent="collection.compute"),
        _event("metric.compute/AUROC", 652, 196, parent="collection.compute"),
        _event("collection.compute", 101, 798),
    ]]
    return trace, ring


def test_the_join_puts_device_and_idle_time_where_it_belongs():
    trace, ring = _hand_trace()
    s = spans.join(trace, ring, {"deferred.fold_calls{shape=ragged}": 2.0}, 7)
    assert s.passes == 1 and s.matched == 6 and s.clock_gap_us == 0.003
    assert s.fold_device_ms == 140 / 1e6
    assert s.compute_fn_device_ms == (60 + 50) / 1e6
    assert s.device_member[("deferred.fold/Acc", "top1", "ragged")] == 140 / 1e6
    # busy 20 + 140 + 60 + 50 + 35 of 1000 ns; k_update's launch lies in
    # collection.update, k_after's in no collection span
    assert s.shares["outside/none"] == pytest.approx(35 / 305)
    assert s.shares["collection/collection.update"] == pytest.approx(20 / 305)
    # idle, by the range at each gap's middle: 0-60 (the update), 80-260
    # (the window step), 400-460 (the terminal compute), 520-710 and
    # 760-955 (compute()), 990-1000 (none: the caller's)
    assert s.port_idle_ms == (60 + 180 + 60 + 190 + 195) / 1e6
    assert s.idle["none"] == 10e-9
    assert s.idle["jit/deferred.window_step"] == 180e-9
    assert s.fold_calls == 2.0
    assert s.compute_ms == [798e-9] and s.fold_host_ms == [95e-9]
    assert s.compute_fn_host_ms == [pytest.approx((98 + 196) * 1e-9)]


def test_a_program_without_the_spans_reads_none():
    trace, ring = _hand_trace()
    # an older program: no parent labels, no deferred spans, no counters
    old = [[{**e, "labels": {}} for e in ring[0] if "deferred." not in e["name"]]]
    trace.ranges = [r for r in trace.ranges if "deferred." not in r[2]]
    s = spans.join(trace, old, {}, 7)
    assert s.fold_host_ms is None and s.compute_fn_host_ms is None and s.reset_ms is None
    assert s.fold_device_ms is None and s.compute_fn_device_ms is None and s.fold_calls is None
    assert s.compute_ms == [798e-9]
    run = SimpleNamespace(spans=s, device_name="cpu")
    for name in HOST + DEVICE + ["hand_kernel_roofline"]:
        value = Spec().module("layer_metrics", name).read(run)
        assert value is None or name in ("update_span_us", "compute_span_ms", "port_idle_ms")


def test_a_fault_in_the_spanned_phase_fails_the_read(monkeypatch):
    def broken(run):
        raise RuntimeError("a fault in the program's span code")

    monkeypatch.setattr(spans, "measure", broken)
    run = SimpleNamespace(device_name="cpu")
    with pytest.raises(RuntimeError, match="span code"):
        Spec().module("layer_metrics", "fold_host_ms").read(run)
    assert not hasattr(run, "spans")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_on_the_card_prints_every_new_metric(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "evalbench/run.py", "--workload", cell, "--seed", str(2**31 + 11),
         "--seconds", "1", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    got = line["metrics"]
    for base in HOST + DEVICE:
        assert got[_name(base, cell)]["value"] is not None, base
    assert ("hand_kernel_roofline" in got) == cell.startswith("imagenet")
