"""Rules the port keeps: it never imports JAX or the JAX package, it runs on
the GPU unless asked for the CPU, and its kernel wrappers never fall back
to their plain versions for a tensor that is not on the CPU."""

import ast
import importlib
import pkgutil
from pathlib import Path

import pytest
import torch

import torcheval_tpu_torch
from torcheval_tpu_torch import _build
from torcheval_tpu_torch.metrics import (
    MAP,
    NDCG,
    BinaryAUROC,
    HitRate,
    MulticlassAccuracy,
    MultilabelAccuracy,
    RecallAtK,
    ReciprocalRank,
    TopKMultilabelAccuracy,
)
from torcheval_tpu_torch.ops.hist import hist
from torcheval_tpu_torch.ops.stream_compact import compact_summary_rows, stream_compact
from torcheval_tpu_torch.ops.topk import topk, topk_kernel

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "torcheval_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "torcheval_tpu"}


def _port_files():
    return sorted(PACKAGE.rglob("*.py")) + [
        ROOT / "chip_smoke.py",
        ROOT / "scripts" / "profile_headline_torch.py",
    ]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(torcheval_tpu_torch.__path__, "torcheval_tpu_torch.")
    )


@pytest.mark.parametrize("name", _modules())
def test_module_imports_and_names_counterpart(name):
    mod = importlib.import_module(name)
    doc = mod.__doc__ or ""
    if not name.split(".")[-1].startswith("_"):
        # every public module names its JAX counterpart (or says it has none)
        assert "torcheval_tpu/" in doc or "JAX counterpart" in doc, name


def test_import_builds_nothing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA test in this process may have built the kernels")
    assert _build._loaded.lib is None


def test_metric_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (MulticlassAccuracy, BinaryAUROC):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(device="cuda")
    assert MulticlassAccuracy(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize(
    "make",
    [MultilabelAccuracy, TopKMultilabelAccuracy, HitRate, ReciprocalRank, NDCG, MAP, RecallAtK],
    ids=lambda c: c.__name__,
)
def test_ranking_and_multilabel_metrics_default_to_cuda(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(device="cuda")
    assert make(device="cpu").device == torch.device("cpu")


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """A machine where the kernels' library is neither built nor buildable,
    and the wrappers believe their tensors are not on the CPU."""

    def no_nvcc():
        raise RuntimeError("nvcc was not found")

    monkeypatch.setattr(_build, "_loaded", _build._Loaded())
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)


def test_wrappers_raise_instead_of_falling_back(no_library):
    before = (hist.launches, stream_compact.launches)
    labels = torch.tensor([0, 1, 1, 5])
    with pytest.raises(RuntimeError, match="nvcc"):
        hist(labels, 3)
    with pytest.raises(RuntimeError, match="nvcc"):
        stream_compact(torch.ones(4, dtype=torch.bool), [torch.zeros(4)])
    s = torch.rand(4)
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="nvcc"):
        compact_summary_rows(s, z, z, torch.ones(4, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="nvcc"):
        MulticlassAccuracy(average="macro", num_classes=3, device="cpu").update(
            torch.rand(4, 3), labels.clamp(max=2)
        )
    assert (hist.launches, stream_compact.launches) == before


def test_topk_wrapper_raises_instead_of_falling_back(no_library):
    before = topk_kernel.launches
    x = torch.rand(4, 2000)
    with pytest.raises(RuntimeError, match="nvcc"):
        topk_kernel(x, 5)
    with pytest.raises(RuntimeError, match="nvcc"):
        topk(x, 5, method="kernel")
    # auto decides by the tensor's device; a CPU tensor stays dense
    assert topk(x, 5)[1].shape == (4, 5)
    with pytest.raises(RuntimeError, match="nvcc"):
        TopKMultilabelAccuracy(k=5, topk_method="kernel", device="cpu").update(
            x, torch.zeros(4, 2000, dtype=torch.int32)
        )
    with pytest.raises(RuntimeError, match="nvcc"):
        NDCG(k=5, topk_method="kernel", device="cpu").update(x, torch.rand(4, 2000))
    assert topk_kernel.launches == before


def test_wrapper_refuses_non_cuda_device_after_loading(monkeypatch):
    # with a library in hand, a tensor that is neither CPU nor CUDA is refused
    monkeypatch.setattr(_build, "library", lambda: object())
    with pytest.raises(ValueError, match="CUDA tensors"):
        hist(torch.zeros(4, dtype=torch.int64, device="meta"), 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        stream_compact(torch.ones(4, dtype=torch.bool, device="meta"), [torch.zeros(4, device="meta")])
    with pytest.raises(ValueError, match="CUDA tensors"):
        topk_kernel(torch.zeros(4, 2000, device="meta"), 5)
