"""Find the benchmark's parts by name.

Everything that belongs to one configuration, cell or metric sits in a file
of its own, and nothing here names one:

* ``BENCHMARK.json`` (the checkout's root): the cells and the metrics;
* ``evalbench/configs/<config>.json``: a deployment (source, sizes, metric
  suite, generator, limits of the comparison);
* ``evalbench/workloads/<cell>.json``: a cell (config, batch rows, why);
* ``evalbench/generators/<name>.py``: ``make(seed, rows, device, params)``;
* ``evalbench/reference/<MetricClass>.py``: ``reference(args, kwargs, dtype)``;
* ``evalbench/end_to_end/<metric>.py`` and
  ``evalbench/layer_metrics/<metric>.py``: ``read(run)`` (a metric
  ``<base>.<group>`` without a file of its own is read by ``<base>.py``).

A later cell, configuration or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")

# the checkout's root: evalbench/core/spec.py -> ../..
ROOT = Path(__file__).resolve().parents[2]


def check_name(name: str) -> str:
    """A name as the benchmark's contract allows it (and so a safe file
    name): letters, digits, ``_``, ``.`` and ``-``, at most 64."""
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


class Spec:
    """The benchmark as it lies under ``root`` (a checkout's root)."""

    def __init__(self, root: Optional[Path] = None) -> None:
        self.root = Path(root) if root is not None else ROOT
        self.base = self.root / "evalbench"
        self._modules: Dict[tuple, ModuleType] = {}

    def _json(self, path: Path) -> Any:
        with open(path, encoding="utf-8") as f:
            return json.load(f)

    def benchmark(self) -> Dict[str, Any]:
        return self._json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> Dict[str, Any]:
        return self._json(self.base / "workloads" / f"{check_name(name)}.json")

    def config(self, name: str) -> Dict[str, Any]:
        return self._json(self.base / "configs" / f"{check_name(name)}.json")

    def module(self, kind: str, name: str) -> ModuleType:
        """``evalbench/<kind>/<name>.py``, loaded from its path (a metric's
        name may hold dots), once per spec. A name ``<base>.<group>`` with
        no file of its own is read by ``<base>``'s: one quantity, reported
        under its own name (and bound) in a group of cells."""
        key = (kind, check_name(name))
        if key not in self._modules:
            path = self.base / kind / f"{name}.py"
            if not path.is_file() and "." in name:
                path = self.base / kind / f"{name.split('.', 1)[0]}.py"
            if not path.is_file():
                raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
            spec = importlib.util.spec_from_file_location(
                f"evalbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path
            )
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def metrics_for(self, section: str, cell: str) -> List[Dict[str, Any]]:
        """The entries of ``BENCHMARK.json``'s ``end_to_end`` or
        ``per_layer`` that ``cell`` reports: those that list it under
        ``workloads``; without that key, an end-to-end metric is in every
        cell, and a per-layer metric in every cell that reports the
        end-to-end metric it ``moves``."""
        bench = self.benchmark()
        end_to_end = {m["name"]: m for m in bench["end_to_end"]}

        def reports(m: Dict[str, Any]) -> bool:
            if "workloads" in m:
                return cell in m["workloads"]
            return "moves" not in m or reports(end_to_end[m["moves"]])

        return [m for m in bench[section] if reports(m)]
