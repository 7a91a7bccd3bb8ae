"""The no-JAX guard, and a run that finds no card."""

import ast
import os
import subprocess
import sys

import pytest

from evalbench.core import guard
from evalbench.core.spec import ROOT, Spec

FILES = sorted((ROOT / "evalbench").rglob("*.py"))


def imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_benchmark_imports_jax(path):
    assert not guard.FORBIDDEN.intersection(imported_roots(path))


@pytest.mark.parametrize("path", sorted((Spec().base / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_port(path):
    assert not (guard.FORBIDDEN | {"torcheval_tpu_torch"}).intersection(imported_roots(path))


def test_names_are_compared_whole():
    mods = ["jax.numpy", "torcheval_tpu_torch.metrics", "torcheval_tpu.ops", "jaxlib", "flaxen", "flax.linen", "torch"]
    assert guard.forbidden_modules(mods) == ["flax", "jax", "jaxlib", "torcheval_tpu"]
    assert guard.forbidden_modules(["torcheval_tpu_torch", "torcheval_tpu_torchx"]) == []


def test_the_harness_and_the_port_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import evalbench.core.harness, evalbench.readings\n"
        "from evalbench.core.spec import Spec\n"
        "from evalbench.core import harness, guard\n"
        "import torcheval_tpu_torch.metrics, torcheval_tpu_torch.obs.registry\n"
        "spec = Spec()\n"
        "for w in spec.benchmark()['workloads']:\n"
        "    c = harness.Cell(spec, w['name'])\n"
        "for m in spec.benchmark()['end_to_end']: spec.module('end_to_end', m['name'])\n"
        "for m in spec.benchmark()['per_layer']: spec.module('layer_metrics', m['name'])\n"
        "print(guard.forbidden_modules())\n" % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "evalbench/run.py", "--workload", "imagenet1k_val_eval.b256",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env,
    )
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr
