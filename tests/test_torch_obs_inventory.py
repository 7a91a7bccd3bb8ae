"""Inventory lint: the port records the JAX package's instrument names and
no others.

* Every ``.counter/.gauge/.histo("…")`` literal under
  ``torcheval_tpu_torch/`` is a row of ``docs/observability.md``'s metric
  inventory (the JAX package's contract) and a row of the port's own table,
  ``torcheval_tpu_torch/obs/inventory.py``, whose kind it matches.
* Every inventory name whose JAX call site lies in a module the port has
  (the same path under ``torcheval_tpu_torch/``) is recorded by the port.
  ``serve.*`` waits for the serve plane.
* ``obs/__init__.py`` exports every name of the JAX ``obs.__all__``
  (``watched`` where the JAX package has ``watched_jit``), and the plain
  counter attributes the registry replaced are gone.

The scan mirrors ``tests/obs/test_doc_inventory.py``.
"""

import re
from pathlib import Path

import pytest

import torcheval_tpu.obs as jax_obs
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.obs.inventory import (
    COST_ENTRIES,
    ENTRIES,
    INSTRUMENTS,
    KERNEL_ENTRIES,
    LABEL_VALUES,
)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "torcheval_tpu_torch"
JAX = ROOT / "torcheval_tpu"
DOC = ROOT / "docs" / "observability.md"
_CALL = re.compile(r'\.(counter|gauge|histo)\(\s*"([^"]+)"')
_ROW = re.compile(r"^\|\s*`([^`{]+)(?:\{[^`]*\})?`\s*\|\s*(\w+)\s*\|")
_KIND = {"counter": "counter", "gauge": "gauge", "histo": "histogram"}


def _literals(package: Path):
    """``{name: {(kind, relative path), ...}}`` of every recording call."""
    out = {}
    for path in sorted(package.rglob("*.py")):
        for kind, name in _CALL.findall(path.read_text()):
            out.setdefault(name, set()).add((_KIND[kind], path.relative_to(package).as_posix()))
    return out


def _doc_rows():
    doc = DOC.read_text()
    section = re.search(r"^## Metric inventory$(.*?)^## ", doc, re.M | re.S).group(1)
    rows = {}
    for line in section.splitlines():
        m = _ROW.match(line.strip())
        if m and m.group(1) not in ("metric", "---"):
            rows[m.group(1)] = m.group(2)
    return rows


PORT_LITERALS = _literals(PORT)
JAX_LITERALS = _literals(JAX)
DOC_ROWS = _doc_rows()


def test_the_scans_found_something():
    assert len(PORT_LITERALS) > 30 and len(DOC_ROWS) > 60


@pytest.mark.parametrize("name", sorted(PORT_LITERALS))
def test_every_port_name_is_a_jax_inventory_row(name):
    assert name in DOC_ROWS, f"{name} is not in docs/observability.md's inventory"
    assert name in INSTRUMENTS, f"{name} is not in obs/inventory.py"
    kinds = {kind for kind, _ in PORT_LITERALS[name]}
    assert kinds == {INSTRUMENTS[name][0]} == {DOC_ROWS[name]}


@pytest.mark.parametrize("name", sorted(INSTRUMENTS))
def test_every_table_row_is_recorded_by_the_port(name):
    assert name in PORT_LITERALS, f"obs/inventory.py lists {name}, which the port never records"


def _ported_jax_names():
    """Inventory names whose JAX call site is in a module the port has."""
    out = []
    for name, sites in JAX_LITERALS.items():
        if name.startswith("serve.") or name not in DOC_ROWS:
            continue
        if any((PORT / rel).exists() for _, rel in sites):
            out.append(name)
    return sorted(out)


@pytest.mark.parametrize("name", _ported_jax_names())
def test_every_ported_jax_call_site_is_recorded(name):
    assert name in PORT_LITERALS, (
        f"{name} is recorded by the JAX package in {sorted(r for _, r in JAX_LITERALS[name])}, "
        "a module the port has, but the port never records it"
    )


def test_the_tables_are_consistent():
    assert set(KERNEL_ENTRIES) <= set(COST_ENTRIES) <= set(ENTRIES)
    for (instrument, key), mapping in LABEL_VALUES.items():
        assert instrument in INSTRUMENTS and key in INSTRUMENTS[instrument][1]
        assert set(mapping) <= {"cuda", "torch"}


def test_obs_exports_every_jax_name():
    want = {"watched" if n == "watched_jit" else n for n in jax_obs.__all__}
    assert want <= set(obs.__all__)
    for name in want:
        assert hasattr(obs, name), name


@pytest.mark.parametrize(
    "module,attribute",
    [
        ("torcheval_tpu_torch.ops.hist", "hist.launches"),
        ("torcheval_tpu_torch.ops.stream_compact", "stream_compact.launches"),
        ("torcheval_tpu_torch.ops.topk", "topk_kernel.launches"),
        ("torcheval_tpu_torch.ops.scatter", "segment_sum.launches"),
        ("torcheval_tpu_torch.metrics.toolkit", "_allgather_stacked.rounds"),
        ("torcheval_tpu_torch.metrics.toolkit", "_sync_failure.count"),
        ("torcheval_tpu_torch.metrics.toolkit", "_encode_sync_entry.quantize_fallbacks"),
        ("torcheval_tpu_torch.metrics.deferred", "window_step.calls"),
        ("torcheval_tpu_torch.metrics.deferred", "fold_pending.calls"),
        ("torcheval_tpu_torch.ops.dist_curves", "record_call.calls"),
        ("torcheval_tpu_torch.ops.dist_curves", "exchange_buckets.calls"),
        ("torcheval_tpu_torch.parallel.bootstrap", "init_from_env.retries"),
        ("torcheval_tpu_torch.sketch.cache", "_count_fold.folds"),
    ],
)
def test_the_plain_counter_attributes_are_gone(module, attribute):
    import importlib

    obj = importlib.import_module(module)
    owner, attr = attribute.split(".")
    assert not hasattr(getattr(obj, owner), attr)
