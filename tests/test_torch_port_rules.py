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
    BinaryAccuracy,
    BinaryAUROC,
    BinaryF1Score,
    HitRate,
    Max,
    Mean,
    MeanSquaredError,
    Min,
    MulticlassAccuracy,
    MulticlassF1Score,
    MultilabelAccuracy,
    RecallAtK,
    ReciprocalRank,
    SlicedMetricCollection,
    Sum,
    TopKMultilabelAccuracy,
)
from torcheval_tpu_torch.ops.confusion import match_triple_counts
from torcheval_tpu_torch.ops.hist import hist, sharded_class_counts
from torcheval_tpu_torch.ops.scatter import segment_scatter, segment_sum
from torcheval_tpu_torch.ops.stream_compact import compact_summary_rows, stream_compact
from torcheval_tpu_torch.ops.topk import topk, topk_kernel
from torcheval_tpu_torch.utils.test_utils.obs_counts import launches, recording

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


@pytest.mark.parametrize(
    "make",
    [BinaryAccuracy, Sum, Mean, Max, Min, MeanSquaredError],
    ids=lambda c: c.__name__,
)
def test_aggregation_and_regression_metrics_default_to_cuda(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(device="cuda")
    assert make(device="cpu").device == torch.device("cpu")


def test_sliced_members_live_on_their_templates_device(monkeypatch):
    col = SlicedMetricCollection({"acc": BinaryAccuracy(device="cpu"), "mean": Mean(device="cpu")})
    assert all(m.device == torch.device("cpu") for m in col.metrics.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlicedMetricCollection({"acc": BinaryAccuracy()})


@pytest.fixture
def obs_on():
    """The obs registry on (and reset): a kernel's launches are its
    ``jit.calls{entry=}`` there."""
    with recording():
        yield


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


def test_wrappers_raise_instead_of_falling_back(no_library, obs_on):
    before = (launches("hist"), launches("stream_compact"))
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
        ).compute()  # the fold, deferred to the read, reaches the kernel
    assert (launches("hist"), launches("stream_compact")) == before


def test_topk_wrapper_raises_instead_of_falling_back(no_library, obs_on):
    before = launches("topk_kernel")
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
        ).compute()
    with pytest.raises(RuntimeError, match="nvcc"):
        NDCG(k=5, topk_method="kernel", device="cpu").update(x, torch.rand(4, 2000)).compute()
    assert launches("topk_kernel") == before


def test_segment_sum_wrapper_raises_instead_of_falling_back(no_library, obs_on):
    before = (launches("segment_sum"), launches("hist"))
    vals = torch.ones(4, 2, dtype=torch.int32)
    rows = torch.tensor([0, 1, 1, 5])
    with pytest.raises(RuntimeError, match="nvcc"):
        segment_sum(vals, rows, 3)
    for method in ("auto", "kernel"):
        with pytest.raises(RuntimeError, match="nvcc"):
            segment_scatter(vals, rows, 3, method=method)
    # "torch" is the caller's explicit choice of the plain version
    assert segment_scatter(vals, rows, 3, method="torch")[1].tolist() == [2, 2]
    ids = torch.tensor([7, 8, 7, 9])
    with pytest.raises(RuntimeError, match="nvcc"):
        SlicedMetricCollection({"acc": BinaryAccuracy(device="cpu")}).update(
            ids, torch.rand(4), torch.ones(4)
        ).compute()
    # a per-class fold under vmap reaches the segment-sum wrapper unbatched
    with pytest.raises(RuntimeError, match="nvcc"):
        SlicedMetricCollection(
            {"acc": MulticlassAccuracy(average="macro", num_classes=3, device="cpu")}
        ).update(ids, torch.rand(4, 3), torch.tensor([0, 1, 2, 1])).compute()
    assert (launches("segment_sum"), launches("hist")) == before


def test_batched_tensors_never_reach_a_kernel_wrapper():
    labels = torch.tensor([[0, 1, 1], [2, 2, 0]])
    with pytest.raises(RuntimeError):
        torch.func.vmap(lambda x: hist(x, 3))(labels)
    # the class counts' vmap rule unbatches them
    from torcheval_tpu_torch.ops.confusion import class_counts

    got = torch.func.vmap(lambda x: class_counts(x, 3))(labels)
    assert got.tolist() == [[1, 2, 0], [1, 0, 2]]


def test_wrapper_refuses_non_cuda_device_after_loading(monkeypatch):
    # with a library in hand, a tensor that is neither CPU nor CUDA is refused
    monkeypatch.setattr(_build, "library", lambda: object())
    with pytest.raises(ValueError, match="CUDA tensors"):
        hist(torch.zeros(4, dtype=torch.int64, device="meta"), 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        stream_compact(torch.ones(4, dtype=torch.bool, device="meta"), [torch.zeros(4, device="meta")])
    with pytest.raises(ValueError, match="CUDA tensors"):
        topk_kernel(torch.zeros(4, 2000, device="meta"), 5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_sum(torch.zeros(4, 2, device="meta"), torch.zeros(4, dtype=torch.int64, device="meta"), 3)


# ------------------------------------------------ sync and data parallelism
SYNC_SLICE_MODULES = [
    "torcheval_tpu_torch.examples.distributed_example",
    "torcheval_tpu_torch.metrics.classification.f1_score",
    "torcheval_tpu_torch.metrics.functional.classification.f1_score",
    "torcheval_tpu_torch.metrics.toolkit",
    "torcheval_tpu_torch.parallel.bootstrap",
    "torcheval_tpu_torch.parallel.evaluator",
    "torcheval_tpu_torch.parallel.mesh",
    "torcheval_tpu_torch.utils.dist",
    "torcheval_tpu_torch.utils.test_utils.dummy_metric",
    "torcheval_tpu_torch.utils.test_utils.metric_class_tester",
    "torcheval_tpu_torch.utils.test_utils.sync_worker",
]


@pytest.mark.parametrize("name", SYNC_SLICE_MODULES)
def test_sync_slice_modules_are_checked(name):
    # each is one of the modules the no-JAX and counterpart rules above walk
    assert name in _modules()
    path = PACKAGE.joinpath(*name.split(".")[1:]).with_suffix(".py")
    assert path in _port_files()


@pytest.mark.parametrize(
    "make",
    [
        lambda **kw: MulticlassF1Score(num_classes=3, average="macro", **kw),
        lambda **kw: BinaryF1Score(**kw),
    ],
    ids=["MulticlassF1Score", "BinaryF1Score"],
)
def test_f1_metrics_default_to_cuda(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu").device == torch.device("cpu")


def test_f1_and_sharded_counts_raise_instead_of_falling_back(no_library, obs_on):
    before = launches("hist")
    labels = torch.tensor([0, 1, 1, 2])
    with pytest.raises(RuntimeError, match="nvcc"):
        match_triple_counts(labels, labels, 3)
    with pytest.raises(RuntimeError, match="nvcc"):
        sharded_class_counts(labels, 3)
    with pytest.raises(RuntimeError, match="nvcc"):
        MulticlassF1Score(num_classes=3, average="macro", device="cpu").update(
            torch.rand(4, 3), labels
        ).compute()
    assert launches("hist") == before


def _host_moves(path: Path):
    """``(function, line)`` of every call that moves or places data on the
    host: ``.cpu()``, ``.numpy()``, ``torch.device("cpu")`` and a
    ``device="cpu"`` keyword."""
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            if isinstance(child, ast.Call):
                f = child.func
                if isinstance(f, ast.Attribute) and f.attr in ("cpu", "numpy"):
                    found.append((func, child.lineno))
                args = list(child.args) + [k.value for k in child.keywords if k.arg == "device"]
                if any(isinstance(a, ast.Constant) and a.value == "cpu" for a in args):
                    found.append((func, child.lineno))
            visit(child, inner)

    visit(tree, "<module>")
    return found


# the only host moves: the descriptor matrix (shapes and types, never
# state), and the object lane's pickles, which load back onto each metric's
# device; the collective device is the host only for a non-NCCL backend
_HOST_MOVES_ALLOWED = {
    "metrics/toolkit.py": {"_gather_collection_states", "_tree_to_host"},
    "utils/dist.py": {"collective_device"},
}


@pytest.mark.parametrize(
    "rel",
    ["metrics/toolkit.py", "utils/dist.py", "parallel/mesh.py", "parallel/bootstrap.py",
     "parallel/evaluator.py", "ops/dist_curves.py"],
)
def test_sync_and_parallel_never_move_cuda_state_to_the_host(rel):
    allowed = _HOST_MOVES_ALLOWED.get(rel, set())
    bad = [(f, line) for f, line in _host_moves(PACKAGE / rel) if f not in allowed]
    assert not bad, f"{rel}: host moves outside {sorted(allowed)}: {bad}"


def test_nccl_collectives_stay_on_the_card(monkeypatch):
    from torcheval_tpu_torch.utils import dist as tdist

    monkeypatch.setattr(tdist.dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert tdist.collective_device() == torch.device("cuda", 2)
    monkeypatch.setattr(tdist.dist, "get_backend", lambda group=None: "gloo")
    assert tdist.collective_device() == torch.device("cpu")


def test_evaluator_places_metrics_on_the_mesh_device(monkeypatch):
    from torcheval_tpu_torch.parallel import DataParallelMesh, ShardedEvaluator, data_parallel_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data_parallel_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedEvaluator(Sum(device="cpu"))
    meta = DataParallelMesh(size=1, rank=0, device=torch.device("meta"))
    ev = ShardedEvaluator({"acc": MulticlassAccuracy(device="cpu"), "sum": Sum(device="cpu")}, mesh=meta)
    assert all(m.device.type == "meta" for m in ev.metrics.values())
    assert all(m.num_correct.device.type == "meta" for m in [ev.metrics["acc"]])


def _host_syncs(path: Path):
    """``(function, line)`` of every call that waits for the device or
    copies to the host: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
    ``torch.cuda.synchronize()``; and every import of numpy."""
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func
            if isinstance(child, ast.Call) and isinstance(child.func, ast.Attribute):
                if child.func.attr in ("item", "cpu", "tolist", "numpy", "synchronize"):
                    found.append((func, child.lineno))
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in child.names] + [getattr(child, "module", None) or ""]
                if any(n.split(".")[0] == "numpy" for n in names):
                    found.append((func, child.lineno))
            visit(child, inner)

    visit(tree, "<module>")
    return found


# none: the window step stays capturable by a CUDA graph
_HOST_SYNCS_ALLOWED = {"metrics/deferred.py": set()}


@pytest.mark.parametrize("rel", sorted(_HOST_SYNCS_ALLOWED))
def test_window_step_makes_no_host_sync(rel):
    allowed = _HOST_SYNCS_ALLOWED[rel]
    bad = [(f, line) for f, line in _host_syncs(PACKAGE / rel) if f not in allowed]
    assert not bad, f"{rel}: host syncs outside {sorted(allowed)}: {bad}"


def test_host_sync_rule_sees_a_sync(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import numpy as np\n\ndef f(x):\n    return x.sum().item()\n")
    assert _host_syncs(probe) == [("<module>", 1), ("f", 4)]


# ------------------------------- precision, recall, confusion and curves
CLASSIFICATION_SLICE_MODULES = [
    "torcheval_tpu_torch.metrics.classification.binned_precision_recall_curve",
    "torcheval_tpu_torch.metrics.classification.confusion_matrix",
    "torcheval_tpu_torch.metrics.classification.precision",
    "torcheval_tpu_torch.metrics.classification.precision_recall_curve",
    "torcheval_tpu_torch.metrics.classification.recall",
    "torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve",
    "torcheval_tpu_torch.metrics.functional.classification.confusion_matrix",
    "torcheval_tpu_torch.metrics.functional.classification.precision",
    "torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve",
    "torcheval_tpu_torch.metrics.functional.classification.recall",
]


@pytest.mark.parametrize("name", CLASSIFICATION_SLICE_MODULES)
def test_classification_slice_modules_are_checked(name):
    # each is one of the modules the no-JAX and counterpart rules above walk
    assert name in _modules()
    path = PACKAGE.joinpath(*name.split(".")[1:]).with_suffix(".py")
    assert path in _port_files()
    assert not FORBIDDEN.intersection(_imported_roots(path))


# ------------------------------------------------------ the obs slice
OBS_SLICE_MODULES = [
    "torcheval_tpu_torch.obs",
    "torcheval_tpu_torch.obs.annotate",
    "torcheval_tpu_torch.obs.cost",
    "torcheval_tpu_torch.obs.distributed",
    "torcheval_tpu_torch.obs.export",
    "torcheval_tpu_torch.obs.httpd",
    "torcheval_tpu_torch.obs.inventory",
    "torcheval_tpu_torch.obs.recompile",
    "torcheval_tpu_torch.obs.slo",
    "torcheval_tpu_torch.obs.stream",
    "torcheval_tpu_torch.utils.telemetry",
    "torcheval_tpu_torch.utils.test_utils.obs_counts",
    "torcheval_tpu_torch.utils.test_utils.obs_worker",
]


@pytest.mark.parametrize("name", OBS_SLICE_MODULES)
def test_obs_slice_modules_are_checked(name):
    # each is one of the modules the no-JAX and counterpart rules above
    # walk, and imports neither jax nor the JAX package (not even its
    # framework-free obs modules: the port keeps its own copies)
    assert name in _modules() or name == "torcheval_tpu_torch.obs"
    rel = name.split(".")[1:]
    path = PACKAGE.joinpath(*rel, "__init__.py") if name == "torcheval_tpu_torch.obs" else (
        PACKAGE.joinpath(*rel).with_suffix(".py"))
    assert path in _port_files()
    assert not FORBIDDEN.intersection(_imported_roots(path))


# the fold functions of the new metrics and everything they call: a window
# step runs them, and it makes no host sync (see above)
_FOLD_FUNCTIONS = {
    "metrics/classification/confusion_matrix.py": {"_cm_fold", "_bincm_fold"},
    "metrics/classification/precision.py": {"_prec_fold", "_binprec_fold"},
    "metrics/classification/recall.py": {"_rec_fold", "_binrec_fold"},
    "metrics/classification/binned_precision_recall_curve.py": {
        "_binary_binned_fold", "_multiclass_binned_fold", "_binary_binned_deferred_compute",
    },
    "metrics/functional/classification/confusion_matrix.py": {"_binary_prediction"},
    "metrics/functional/classification/precision.py": {
        "_precision_update", "_binary_precision_update", "_precision_compute",
    },
    "metrics/functional/classification/recall.py": {
        "_recall_update", "_binary_recall_update", "_recall_compute", "_binary_recall_compute",
    },
    "metrics/functional/classification/binned_precision_recall_curve.py": {
        "_buckets", "_above", "_binary_binned_update", "_binary_binned_compute",
        "_multiclass_binned_update",
    },
    "metrics/functional/classification/f1_score.py": {"_f1_score_update", "_f1_score_compute"},
    "metrics/classification/click_through_rate.py": {"_ctr_deferred_fold"},
    "metrics/classification/weighted_calibration.py": {"_calibration_deferred_fold"},
    "metrics/classification/binary_normalized_entropy.py": {"_ne_deferred_fold"},
    "metrics/regression/r2_score.py": {"_r2_deferred_fold"},
    "metrics/functional/classification/click_through_rate.py": {
        "_ctr_fold", "_as_f32", "_ctr_compute",
    },
    "metrics/functional/classification/weighted_calibration.py": {
        "_calibration_fold", "_calibration_compute",
    },
    "metrics/functional/classification/binary_normalized_entropy.py": {"_ne_fold", "_baseline_entropy"},
    "metrics/functional/regression/r2_score.py": {"_r2_fold"},
}


@pytest.mark.parametrize("rel", sorted(_FOLD_FUNCTIONS))
def test_fold_functions_make_no_host_sync(rel):
    names = _FOLD_FUNCTIONS[rel]
    tree = ast.parse((PACKAGE / rel).read_text())
    defined = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    assert names <= defined, f"{rel}: {sorted(names - defined)} not found"
    bad = [(f, line) for f, line in _host_syncs(PACKAGE / rel) if f in names]
    assert not bad, f"{rel}: host syncs in fold functions: {bad}"


def test_confusion_ops_make_no_host_sync():
    assert not _host_syncs(PACKAGE / "ops" / "confusion.py")


def _new_metrics():
    from torcheval_tpu_torch.metrics import (
        BinaryBinnedPrecisionRecallCurve,
        BinaryConfusionMatrix,
        BinaryPrecision,
        BinaryPrecisionRecallCurve,
        BinaryRecall,
        MulticlassAUPRC,
        MulticlassAUROC,
        MulticlassBinnedPrecisionRecallCurve,
        MulticlassConfusionMatrix,
        MulticlassPrecision,
        MulticlassPrecisionRecallCurve,
        MulticlassRecall,
    )

    return [
        lambda **kw: MulticlassConfusionMatrix(3, **kw),
        lambda **kw: BinaryConfusionMatrix(**kw),
        lambda **kw: MulticlassPrecision(num_classes=3, average="macro", **kw),
        lambda **kw: BinaryPrecision(**kw),
        lambda **kw: MulticlassRecall(num_classes=3, average="macro", **kw),
        lambda **kw: BinaryRecall(**kw),
        lambda **kw: BinaryBinnedPrecisionRecallCurve(threshold=5, **kw),
        lambda **kw: MulticlassBinnedPrecisionRecallCurve(3, threshold=5, **kw),
        lambda **kw: BinaryPrecisionRecallCurve(**kw),
        lambda **kw: MulticlassPrecisionRecallCurve(num_classes=3, **kw),
        lambda **kw: MulticlassAUROC(num_classes=3, **kw),
        lambda **kw: MulticlassAUPRC(num_classes=3, **kw),
    ]


@pytest.mark.parametrize("i", range(12))
def test_classification_slice_metrics_default_to_cuda(monkeypatch, i):
    make = _new_metrics()[i]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    assert make(device="cpu").device == torch.device("cpu")


def test_classification_slice_raises_instead_of_falling_back(no_library, obs_on):
    from torcheval_tpu_torch.metrics import (
        MulticlassAUROC,
        MulticlassBinnedPrecisionRecallCurve,
        MulticlassConfusionMatrix,
        MulticlassPrecision,
    )

    before = (launches("hist"), launches("segment_sum"), launches("stream_compact"))
    labels = torch.tensor([0, 1, 1, 2])
    scores = torch.rand(4, 3)
    with pytest.raises(RuntimeError, match="nvcc"):
        MulticlassConfusionMatrix(3, device="cpu").update(labels, labels).compute()
    with pytest.raises(RuntimeError, match="nvcc"):
        MulticlassPrecision(num_classes=3, average=None, device="cpu").update(scores, labels).compute()
    # one batch folds on the histogram, a stacked window on the segment sum
    with pytest.raises(RuntimeError, match="nvcc"):
        MulticlassBinnedPrecisionRecallCurve(3, threshold=5, device="cpu").update(scores, labels).compute()
    binned = MulticlassBinnedPrecisionRecallCurve(3, threshold=5, device="cpu")
    binned.update(scores, labels).update(torch.rand(4, 3), labels)
    with pytest.raises(RuntimeError, match="nvcc"):
        binned.compute()
    # the per-class compaction reaches the compaction kernel
    with pytest.raises(RuntimeError, match="nvcc"):
        MulticlassAUROC(num_classes=3, compaction_threshold=4, device="cpu").update(scores, labels)
    assert (launches("hist"), launches("segment_sum"), launches("stream_compact")) == before


# ------------------------------------------------------ the sharded forms
SHARDED_SLICE_MODULES = [
    "torcheval_tpu_torch.metrics.functional.ranking.retrieval",
    "torcheval_tpu_torch.metrics.ranking._retrieval",
    "torcheval_tpu_torch.metrics.sliced",
    "torcheval_tpu_torch.ops.scatter",
    "torcheval_tpu_torch.ops.topk",
    "torcheval_tpu_torch.parallel.mesh",
    "torcheval_tpu_torch.sketch.cache",
    "torcheval_tpu_torch.utils.dist",
    "torcheval_tpu_torch.utils.test_utils.sharded_worker",
]


@pytest.mark.parametrize("name", SHARDED_SLICE_MODULES)
def test_sharded_slice_modules_are_checked(name):
    # each is one of the modules the no-JAX and counterpart rules above walk
    assert name in _modules()
    path = PACKAGE.joinpath(*name.split(".")[1:]).with_suffix(".py")
    assert path in _port_files()
    assert not FORBIDDEN.intersection(_imported_roots(path))


@pytest.fixture
def world_of_one():
    """A gloo world of one rank in this process and a 1-D mesh over it,
    with the dims ``label`` and, as a second mesh, ``slices``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield (init_device_mesh("cpu", (1,), mesh_dim_names=("label",)),
               init_device_mesh("cpu", (1,), mesh_dim_names=("slices",)))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("make", [NDCG, MAP, RecallAtK])
def test_label_mesh_metrics_default_to_cuda(monkeypatch, world_of_one, make):
    label, _ = world_of_one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(k=3, label_mesh=(label, "label"))
    assert make(k=3, label_mesh=(label, "label"), device="cpu").device == torch.device("cpu")


def test_sharded_sliced_members_live_on_their_templates_device(monkeypatch, world_of_one):
    _, slices = world_of_one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlicedMetricCollection({"acc": BinaryAccuracy()}, mesh=slices, mesh_axis="slices")
    col = SlicedMetricCollection({"acc": BinaryAccuracy(device="cpu")}, mesh=slices, mesh_axis="slices")
    assert col.metrics["acc"].device == torch.device("cpu")


def test_sharded_forms_raise_instead_of_falling_back(no_library, world_of_one, obs_on):
    from torcheval_tpu_torch.ops.scatter import sharded_segment_sum
    from torcheval_tpu_torch.ops.topk import sharded_label_topk, sharded_topk_kernel
    from torcheval_tpu_torch.sketch.cache import sliced_score_hist_fold
    from torcheval_tpu_torch.utils.dist import mesh_axis

    label, slices = world_of_one
    before = (launches("topk_kernel"), launches("segment_sum"))
    x = torch.rand(4, 2000)
    with pytest.raises(RuntimeError, match="nvcc"):
        sharded_topk_kernel(x, 5)
    with pytest.raises(RuntimeError, match="nvcc"):
        sharded_label_topk(x, 5, mesh=label, label_axis="label", method="kernel")
    with pytest.raises(RuntimeError, match="nvcc"):
        NDCG(k=5, topk_method="kernel", label_mesh=(label, "label"), device="cpu").update(
            x, torch.rand(4, 2000)
        ).compute()
    vals = torch.ones(4, 2, dtype=torch.int32)
    rows = torch.tensor([0, 1, 1, 5])
    with pytest.raises(RuntimeError, match="nvcc"):
        segment_scatter(vals, rows, 4, mesh=slices, axis="slices")
    with pytest.raises(RuntimeError, match="nvcc"):
        sharded_segment_sum(vals, rows, 4)
    with pytest.raises(RuntimeError, match="nvcc"):
        sliced_score_hist_fold(rows.to(torch.int32), torch.rand(4), torch.ones(4), 4, 8,
                               shard=mesh_axis(slices, "slices"))
    with pytest.raises(RuntimeError, match="nvcc"):
        SlicedMetricCollection(
            {"acc": BinaryAccuracy(device="cpu")}, mesh=slices, mesh_axis="slices"
        ).update(torch.tensor([7, 8, 7, 9]), torch.rand(4), torch.ones(4)).compute()
    assert (launches("topk_kernel"), launches("segment_sum")) == before


def test_mesh_axis_names_are_checked(world_of_one):
    from torcheval_tpu_torch.parallel import label_tile, mesh_axis, shard_tile_width, tile_bounds

    label, _ = world_of_one
    with pytest.raises(ValueError, match="'slices' is not a dim"):
        mesh_axis(label, "slices")
    with pytest.raises(ValueError, match="not a dim"):
        mesh_axis(object(), "label")
    ax = mesh_axis(label, "label")
    assert (ax.size, ax.rank, ax.name) == (1, 0, "label")
    assert label_tile(torch.arange(12).reshape(2, 6), label, "label").shape == (2, 6)
    assert shard_tile_width(10, 4) == 3
    assert [tile_bounds(10, 4, r) for r in range(4)] == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert tile_bounds(2, 4, 3) == (2, 2)


# ------------------------------------------------- the distributed curves
DIST_CURVES_SLICE_MODULES = [
    "torcheval_tpu_torch.metrics.classification.auroc",
    "torcheval_tpu_torch.ops.dist_curves",
    "torcheval_tpu_torch.parallel.evaluator",
    "torcheval_tpu_torch.utils.dist",
    "torcheval_tpu_torch.utils.test_utils.dist_curves_worker",
]


@pytest.mark.parametrize("name", DIST_CURVES_SLICE_MODULES)
def test_dist_curves_slice_modules_are_checked(name):
    assert name in _modules()
    path = PACKAGE.joinpath(*name.split(".")[1:]).with_suffix(".py")
    assert path in _port_files()
    assert not FORBIDDEN.intersection(_imported_roots(path))


def _called_attributes(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return {node.func.attr for node in ast.walk(tree)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)}


def test_dist_curves_count_with_the_kernels_not_a_library_op():
    called = _called_attributes(PACKAGE / "ops" / "dist_curves.py")
    assert not {"bincount", "index_add_", "histc", "scatter_add_"} & called
    assert {"hist", "segment_sum"} <= {
        n.id for n in ast.walk(ast.parse((PACKAGE / "ops" / "dist_curves.py").read_text()))
        if isinstance(n, ast.Name)}


@pytest.mark.parametrize("which", ["binary", "multiclass", "sketch"])
def test_dist_curves_raise_instead_of_falling_back(no_library, which, obs_on):
    from torcheval_tpu_torch.ops import dist_curves as dc

    before = (launches("hist"), launches("segment_sum"))
    s, t = torch.rand(8), (torch.rand(8) < 0.5).to(torch.float32)
    x, y = torch.rand(8, 3), torch.tensor([0, 1, 2, 0, 1, 2, 0, 1])
    with pytest.raises(RuntimeError, match="nvcc"):
        if which == "binary":  # the splitter histogram reaches the histogram kernel
            dc.sharded_binary_auroc([s], [t])
        elif which == "multiclass":  # and the per-class one the segment sum
            dc.sharded_multiclass_auprc([x], [y])
        else:
            dc.sharded_sketch_counts([s], [t], bucket_bits=10)
    assert (launches("hist"), launches("segment_sum")) == before


def test_dist_curve_metrics_default_to_cuda(monkeypatch):
    from torcheval_tpu_torch.metrics import MulticlassAUROC

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MulticlassAUROC(num_classes=3)
    m = MulticlassAUROC(num_classes=3, device="cpu")
    assert all(t.device.type == "cpu" for t in m._empty_block())


# --------------------------- recommendation and regression metrics, quant
REC_SLICE_MODULES = [
    "torcheval_tpu_torch.metrics.aggregation.throughput",
    "torcheval_tpu_torch.metrics.classification._windowed",
    "torcheval_tpu_torch.metrics.classification.binary_normalized_entropy",
    "torcheval_tpu_torch.metrics.classification.click_through_rate",
    "torcheval_tpu_torch.metrics.classification.weighted_calibration",
    "torcheval_tpu_torch.metrics.functional.classification._task_shapes",
    "torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy",
    "torcheval_tpu_torch.metrics.functional.classification.click_through_rate",
    "torcheval_tpu_torch.metrics.functional.classification.weighted_calibration",
    "torcheval_tpu_torch.metrics.functional.regression.r2_score",
    "torcheval_tpu_torch.metrics.regression.r2_score",
    "torcheval_tpu_torch.metrics.toolkit",
    "torcheval_tpu_torch.ops.dist_curves",
    "torcheval_tpu_torch.utils.quant",
    "torcheval_tpu_torch.utils.tracing",
    "torcheval_tpu_torch.utils.test_utils.quant_sync_worker",
]


@pytest.mark.parametrize("name", REC_SLICE_MODULES)
def test_rec_slice_modules_are_checked(name):
    # each is one of the modules the no-JAX and counterpart rules above walk
    assert name in _modules()
    path = PACKAGE.joinpath(*name.split(".")[1:]).with_suffix(".py")
    assert path in _port_files()
    assert not FORBIDDEN.intersection(_imported_roots(path))


def _rec_metrics():
    from torcheval_tpu_torch.metrics import (
        BinaryNormalizedEntropy,
        ClickThroughRate,
        R2Score,
        Throughput,
        WeightedCalibration,
        WindowedClickThroughRate,
        WindowedWeightedCalibration,
    )

    return [BinaryNormalizedEntropy, ClickThroughRate, WeightedCalibration,
            WindowedClickThroughRate, WindowedWeightedCalibration, R2Score, Throughput]


@pytest.mark.parametrize("i", range(7))
def test_rec_metrics_default_to_cuda_and_raise_without_it(monkeypatch, i):
    make = _rec_metrics()[i]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(device="cuda")
    assert make(device="cpu").device == torch.device("cpu")


# the value warnings: every host read runs inside the daemon thread's
# worker or the nested check it calls, never in the caller's frame
_WARNING_FUNCTIONS = {
    "utils/tracing.py": {"async_value_warn", "host_resident", "join_pending"},
    "metrics/functional/classification/precision.py": {"_warn_nan_classes"},
    "metrics/functional/classification/recall.py": {"_warn_nan_recall", "_warn_no_positive"},
    "metrics/functional/classification/f1_score.py": {"_warn_empty_classes"},
    "metrics/aggregation/mean.py": {"_on_window_result"},
    "metrics/aggregation/throughput.py": {"compute"},
}


@pytest.mark.parametrize("rel", sorted(_WARNING_FUNCTIONS))
def test_async_value_warn_never_blocks_the_caller(rel):
    names = _WARNING_FUNCTIONS[rel]
    tree = ast.parse((PACKAGE / rel).read_text())
    defined = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    assert names <= defined, f"{rel}: {sorted(names - defined)} not found"
    bad = [(f, line) for f, line in _host_syncs(PACKAGE / rel) if f in names]
    assert not bad, f"{rel}: host reads in the caller's frame: {bad}"
    if rel != "utils/tracing.py":
        assert "async_value_warn" in {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}


def test_quantized_dist_curves_raise_instead_of_falling_back(no_library):
    from torcheval_tpu_torch.ops import dist_curves as dc

    before = (launches("hist"), launches("segment_sum"))
    s, t = torch.rand(8), (torch.rand(8) < 0.5).to(torch.float32)
    for mode in ("bf16", "int8"):
        with pytest.raises(RuntimeError, match="nvcc"):
            dc.sharded_binary_auroc([s], [t], quantize=mode)
    assert (launches("hist"), launches("segment_sum")) == before
