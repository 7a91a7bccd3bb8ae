"""The sketch cell, ``criteo1tb_ctr_eval_approx.whole``, at a size that a
CPU test holds (2^20 rows in one batch): the check that decides
``correct`` fails the control (the reference in bfloat16) and the faults
planted under the timed path; NE, CTR and calibration pass their limits;
the program's AUROC is the bucketed AUROC of ``reference/
_bucketed_auroc.py``. (The AUROC's limit is set at the cell's 89M rows,
where the sketch's gap to the exact AUROC is its bias, about 9e-6; at
small sizes the gap also holds sampling noise, about 4e-5 at 120K rows,
so this test holds the AUROC to the bucketed reference instead.) A CPU
``--trace 1`` run prints the new host-read metrics, and the join puts the
fold's device time where it belongs; the card's run, which prints every
new metric, carries the ``cuda`` marker."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from evalbench.core import harness, spans
from evalbench.core.spec import ROOT, Spec
from evalbench.reference._bucketed_auroc import bucketed_auroc
from evalbench.tests.conftest import small_run
from evalbench.tests.test_evalbench_control import _altered, _half_batch, _unchanged

CELL = "criteo1tb_ctr_eval_approx.whole"
ROWS = 1 << 20
SEED = 2**31 + 7
# the program's float32 integration of the counts against the float64
# bucketed reference (tests/test_torch_sketch_criteo.py says why)
FLOAT32_TOLERANCE = 1e-6
EXACT_MEMBERS = ("ne", "ctr", "calibration")
NEW = ["sketch_fold_device_ms", "sketch_fold_host_ms", "sketch_folds_per_pass",
       "sketch_fold_roofline", "hand_kernel_ms_per_pass"]


def _run(**kw):
    return small_run(CELL, rows=ROWS, batch=ROWS, seed=SEED, **kw)


def _failed(run):
    return {k for k, (g, limit) in run.checks.items() if not g <= limit}


class _Recording(harness.Program):
    """The program, keeping each pass's values on the host."""

    seen = []

    def compute(self):
        out = super().compute()
        _Recording.seen.append(harness.to_host(out))
        return out


def test_the_program_agrees_with_the_bucketed_reference_and_the_exact_members_pass():
    _Recording.seen = []
    run = _run(program_factory=_Recording)
    assert run.compared >= 1
    assert not _failed(run) & set(EXACT_MEMBERS)
    cell = harness.Cell(Spec(), CELL, rows=ROWS, batch_rows=ROWS)
    inputs = cell.inputs(SEED, torch.device("cpu"))
    want = float(bucketed_auroc(inputs["logits"], inputs["labels"]))
    assert _Recording.seen
    for values in _Recording.seen:
        assert abs(float(values["auroc"]) - want) / want <= FLOAT32_TOLERANCE


def test_the_control_is_not_correct():
    run = _run(program_factory=harness.ControlProgram)
    assert not run.correct and run.failed == run.compared
    # bfloat16 fails a member that the program passes
    assert _failed(run) & set(EXACT_MEMBERS)


@pytest.mark.parametrize("fault,fails", [
    (_unchanged, set(EXACT_MEMBERS) | {"auroc"}),
    (_half_batch, {"ctr"}),
    (_altered, {"auroc"}),  # the first collection's first value: the AUROC, by 1e-3
])
def test_a_fault_under_the_timed_path_is_not_correct(fault, fails, monkeypatch):
    fault(monkeypatch)
    run = _run()
    assert not run.correct
    assert fails <= _failed(run)


def test_a_cpu_trace_run_prints_the_host_read_sketch_metrics():
    run = _run(trace=True)
    got = harness.result_line(run, Spec(), True)["metrics"]
    assert got["sketch_folds_per_pass.device_bound"]["value"] == 1
    assert got["sketch_fold_host_ms.device_bound"]["value"] > 0
    # no device on the CPU: the device-timed ones are left out
    for base in ("sketch_fold_device_ms", "sketch_fold_roofline", "hand_kernel_ms_per_pass"):
        assert base + ".device_bound" not in got
    # the fold span sits inside the update, outside every phase
    assert not any(own.startswith("metric.fold/") for own, _, _ in run.spans.device_member)
    (fold,) = [k for k in run.spans.host_member if k[0].startswith("metric.fold/")]
    assert fold == ("metric.fold/BinaryAUROC", "", "")


def _event(name, t0_ns, dur_ns, parent=None, **labels):
    if parent:
        labels["parent"] = parent
    path = f"{parent}/{name}" if parent else name
    return {"ts": t0_ns / 1e9, "dur": dur_ns / 1e9, "name": path, "kind": "span",
            "labels": labels, "tid": 7}


def _hand_trace(fold=True):
    """One pass (0-1000 ns): an update (10-500) whose metric update
    (20-490) folds (30-480: bucket keys, then a segment sum at 300-470),
    and a compute (550-900)."""
    rng = [(10, 500, "collection.update"), (20, 490, "metric.update/BinaryAUROC"),
           (550, 900, "collection.compute"), (560, 890, "metric.compute/BinaryAUROC")]
    if fold:
        rng += [(30, 480, "metric.fold/BinaryAUROC"), (300, 470, "jit/segment_sum")]
    trace = SimpleNamespace(
        passes=[(0, 1000, "evalbench.pass", 1)],
        ranges=[(s, e, n, 1) for s, e, n in rng],
        # launched at 15 (the update's own), 100 (the keys), 310 (the
        # memset), 320 (the segment sum), 600 (the compute)
        device=[(16, 30, "k_input", 1, 0), (110, 290, "k_keys", 2, 0), (311, 320, "memset", 3, 0),
                (321, 521, "segment_sum_kernel", 4, 0), (600, 700, "k_auroc", 5, 0)],
        runtime={1: 15, 2: 100, 3: 310, 4: 320, 5: 600},
        host={},
    )
    upd = "collection.update/metric.update/BinaryAUROC"
    ring = [_event("collection.update", 11, 489), _event("metric.update/BinaryAUROC", 21, 469,
                                                          parent="collection.update"),
            _event("collection.compute", 551, 349), _event("metric.compute/BinaryAUROC", 561, 329,
                                                            parent="collection.compute")]
    if fold:
        ring += [_event("metric.fold/BinaryAUROC", 31, 449, parent=upd, kind="score"),
                 _event("jit/segment_sum", 301, 169, parent=upd + "/metric.fold/BinaryAUROC")]
    return trace, [ring]


def _read(name, s):
    run = SimpleNamespace(spans=s, device_name="NVIDIA H100 80GB HBM3", rows_per_pass=ROWS,
                          cell=harness.Cell(Spec(), CELL, rows=ROWS, batch_rows=ROWS))
    return Spec().module("layer_metrics", name).read(run)


def test_the_join_puts_the_folds_device_time_where_it_belongs():
    s = spans.join(*_hand_trace(), {}, 7)
    assert s.matched == 6
    # the keys, the memset and the segment sum: 180 + 9 + 200 of 503 ns busy
    assert _read("sketch_fold_device_ms", s) == pytest.approx((180 + 9 + 200) / 1e6)
    assert _read("sketch_fold_host_ms", s) == pytest.approx(449 / 1e6)
    least = ROWS * 8 + 2 * (1 << 16) * 4
    assert _read("sketch_fold_roofline", s) == pytest.approx(
        100 * least / 3.35e12 / ((180 + 9 + 200) / 1e9))


def test_a_program_without_the_fold_span_reads_none():
    s = spans.join(*_hand_trace(fold=False), {}, 7)
    for name in ("sketch_fold_device_ms", "sketch_fold_host_ms", "sketch_fold_roofline"):
        assert _read(name, s) is None
    run = SimpleNamespace(obs_counters={"deferred.fold_calls{shape=concat}": 3.0}, obs_passes=2)
    assert Spec().module("layer_metrics", "sketch_folds_per_pass").read(run) is None
    run.obs_counters["sketch.folds{kind=score}"] = 2.0
    assert Spec().module("layer_metrics", "sketch_folds_per_pass").read(run) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_on_the_card_is_correct_and_prints_every_new_metric(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "evalbench/run.py", "--workload", CELL, "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    if trace:
        got = line["metrics"]
        for base in NEW:
            assert got[base + ".device_bound"]["value"] is not None, base
        assert got["sketch_folds_per_pass.device_bound"]["value"] == 1
