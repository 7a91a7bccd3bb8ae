"""A new cell, configuration or metric is new files only: dropped into a
copy of the benchmark, the harness finds and runs each by its name."""

import json
import shutil
from types import SimpleNamespace

import pytest
import torch

from evalbench.core import harness
from evalbench.core.spec import Spec
from evalbench.tests.conftest import small_run


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(Spec().base, root / "evalbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(Spec().root / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_a_dropped_cell_and_metric_are_found_by_name(tmp_path):
    root = _copy(tmp_path)
    (root / "evalbench/workloads/imagenet1k_val_eval.b512.json").write_text(json.dumps({
        "config": "imagenet1k_val_eval", "batch_rows": 512, "chips": 1,
        "why": "a cell added as a file",
    }))
    (root / "evalbench/layer_metrics/passes_seen.py").write_text(
        "def read(run):\n    return float(run.passes)\n"
    )
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "passes_seen", "unit": "passes", "better": "higher", "source": "host_clock",
        "layer": "metric classes and collection", "moves": "preds_per_s",
        "workloads": ["imagenet1k_val_eval.b512"],
    })
    # the cell joins the group of cells that report ``preds_per_s``
    for m in bench["end_to_end"]:
        if m["name"] in ("preds_per_s", "pass_p90_ms"):
            m["workloads"].append("imagenet1k_val_eval.b512")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(root)
    cell = harness.Cell(spec, "imagenet1k_val_eval.b512", rows=2000)
    assert cell.batch_rows == 512 and len(cell.batches(cell.inputs(3, torch.device("cpu")))) == 4
    run = small_run("imagenet1k_val_eval.b512", spec=spec, trace=True, rows=2000)
    assert run.correct
    line = harness.result_line(run, spec, True)
    assert line["metrics"]["passes_seen"]["value"] == float(run.passes)
    # the group's per-layer metrics come with it, another group's do not
    assert "update_host_us" in line["metrics"] and "update_host_us.device_bound" not in line["metrics"]
    # a metric listed for other cells is left out of this one's line
    assert "hand_kernel_ms_per_pass" not in line["metrics"]
    # on the CPU, peak_mem_gib (a CUDA reading) is left out
    assert set(harness.result_line(run, spec, False)["metrics"]) == {
        "preds_per_s", "pass_p90_ms", "setup_s"}


def test_a_metric_of_a_group_is_read_by_its_base_reader(tmp_path):
    root = _copy(tmp_path)
    (root / "evalbench/layer_metrics/passes_seen.py").write_text(
        "def read(run):\n    return float(run.passes)\n"
    )
    (root / "evalbench/layer_metrics/passes_seen.own.py").write_text(
        "def read(run):\n    return -1.0\n"
    )
    spec = Spec(root)
    run = SimpleNamespace(passes=7)
    assert spec.module("layer_metrics", "passes_seen.slow").read(run) == 7.0
    # a name with a file of its own is read by that file
    assert spec.module("layer_metrics", "passes_seen.own").read(run) == -1.0
    with pytest.raises(FileNotFoundError):
        spec.module("layer_metrics", "nothing_here.slow")
