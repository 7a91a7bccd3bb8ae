"""``BENCHMARK.json`` against the rules of its format, and every name in it
against the files that the harness finds by that name."""

import json
import re

import pytest

from evalbench.core.spec import Spec

SPEC = Spec()
BENCH = SPEC.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
TEXT = re.compile(r"[^\t\n\r]{1,200}\Z")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["evalbench"]
    assert BENCH["command"] == ["python3", "evalbench/run.py"]


def _all_names():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


def test_names_and_units_match_the_format():
    for name in _all_names():
        assert NAME.match(name), name
    for section in ("end_to_end", "per_layer"):
        names = [m["name"] for m in BENCH[section]]
        assert len(set(names)) == len(names)
        for m in BENCH[section]:
            assert UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
    for section in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[section]]
        assert len(set(names)) == len(names)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("evalbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_every_name_has_its_files():
    for c in BENCH["configs"]:
        cfg = json.loads((SPEC.root / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        SPEC.module("generators", cfg["generator"])
        for col in cfg["collections"]:
            for m in col["metrics"]:
                assert hasattr(SPEC.module("reference", m["class"]), "reference")
                assert float(m["limit"]) >= 0
    used = set()
    for w in BENCH["workloads"]:
        wl = SPEC.workload(w["name"])
        assert wl["config"] == w["config"] and wl["why"] == w["why"] and wl["chips"] == w["chips"]
        used.add(w["config"])
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"]:
        assert callable(SPEC.module("end_to_end", m["name"]).read)
    for m in BENCH["per_layer"]:
        assert callable(SPEC.module("layer_metrics", m["name"]).read)


def test_every_cell_reports_what_its_metrics_move():
    cells = [w["name"] for w in BENCH["workloads"]]
    for cell in cells:
        e2e = {m["name"] for m in SPEC.metrics_for("end_to_end", cell)}
        layer = SPEC.metrics_for("per_layer", cell)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, cell
        for m in layer:
            assert m["moves"] in e2e, (cell, m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells), m["name"]


@pytest.mark.parametrize("name", ["../x", "a b", "", "x/y", "-x"])
def test_a_name_that_could_leave_its_folder_is_refused(name):
    with pytest.raises(ValueError):
        SPEC.workload(name)
