"""The spans inside a collection's pass, their clock, and the counts beside
them: ``collection.reset`` and each member's ``metric.reset/<Class>``; in a
window step ``deferred.operands``, one ``deferred.fold/<Class>`` per member
(``member=``, ``shape=``) or one ``deferred.fold/stacked`` for the vmapped
members, and ``deferred.compute_fn/<Class>``; ``deferred.fold_calls{shape=}``
against the ``_fold_fn`` calls made; the timeline on the profiler's clock;
``obs.cost.launch_bytes{entry=}`` from a kernel wrapper's byte model.
"""

import collections
import json
import os
import subprocess
import sys
import time

import pytest
import torch

import torcheval_tpu_torch.metrics as T
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.obs import annotate, recompile, registry
from torcheval_tpu_torch.obs import trace as obs_trace
from torcheval_tpu_torch.ops.hist import _hist_cost
from torcheval_tpu_torch.utils.test_utils.obs_counts import count

CPU = "cpu"
C = 12
WINDOW = "collection.compute/jit/deferred.window_step"


@pytest.fixture(autouse=True)
def _clean():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _imagenet_collection():
    """The ImageNet cell's five members, at a small class count."""
    return T.MetricCollection({
        "top1": T.MulticlassAccuracy(device=CPU),
        "top5": T.MulticlassAccuracy(k=5, device=CPU),
        "f1_macro": T.MulticlassF1Score(num_classes=C, average="macro", device=CPU),
        "confusion": T.MulticlassConfusionMatrix(num_classes=C, device=CPU),
        "auroc_macro": T.MulticlassAUROC(num_classes=C, device=CPU),
    })


def _pass(col, rows, batch, seed=0):
    g = torch.Generator().manual_seed(seed)
    scores = torch.rand(rows, C, generator=g)
    labels = torch.randint(0, C, (rows,), generator=g)
    col.reset()
    for s in range(0, rows, batch):
        col.update(scores[s:s + batch], labels[s:s + batch])
    return col.compute()


def _spans():
    return [e for e in obs.timeline_events() if e["kind"] == "span"]


def _own(e):
    parent = e["labels"].get("parent")
    return e["name"][len(parent) + 1:] if parent else e["name"]


# 5 batches of 64 and one of 40 (ragged); 6 of 64 (uniform)
@pytest.mark.parametrize("rows,shape", [(360, "ragged"), (384, "stacked")])
def test_every_span_of_a_pass_has_its_parent_and_labels(rows, shape):
    col = _imagenet_collection()
    _pass(col, rows, 64)  # the first pass validates and arms the window
    obs.enable()
    _pass(col, rows, 64)
    spans = _spans()
    by_own = collections.defaultdict(list)
    for e in spans:
        by_own[_own(e)].append(e)

    assert len(by_own["collection.reset"]) == 1
    assert "parent" not in by_own["collection.reset"][0]["labels"]
    resets = sorted(_own(e) for e in spans if e["labels"].get("parent") == "collection.reset")
    assert resets == sorted(f"metric.reset/{type(m).__name__}" for m in col.metrics.values())

    (ops,) = by_own["deferred.operands"]
    assert ops["labels"]["parent"] == WINDOW
    folds = by_own["deferred.fold/MulticlassAccuracy"]
    assert {e["labels"]["parent"] for e in folds} == {WINDOW}
    assert {e["labels"]["member"] for e in folds} == {"top1", "top5"}
    assert {e["labels"]["shape"] for e in folds} == {shape}
    if shape == "stacked":
        # the vmapped fold of both accuracies is one call: one span, no
        # per-member split; each member's combine is its own span
        (stacked,) = by_own["deferred.fold/stacked"]
        assert stacked["labels"]["members"] == "2" and stacked["labels"]["parent"] == WINDOW
        assert len(folds) == 2
    else:
        assert "deferred.fold/stacked" not in by_own
        assert len(folds) == 4  # the fold and the combine of each
    for cls, member in (("MulticlassF1Score", "f1_macro"), ("MulticlassConfusionMatrix", "confusion")):
        got = by_own[f"deferred.fold/{cls}"]
        assert len(got) == 2
        assert {(e["labels"]["member"], e["labels"]["shape"], e["labels"]["parent"]) for e in got} == {
            (member, "concat", WINDOW)}
    computes = {e["labels"]["member"]: e for e in spans if _own(e).startswith("deferred.compute_fn/")}
    assert set(computes) == {"top1", "top5", "f1_macro", "confusion"}
    assert {e["labels"]["parent"] for e in computes.values()} == {WINDOW}
    # the eager member keeps its metric spans
    (auroc,) = by_own["metric.compute/MulticlassAUROC"]
    assert auroc["labels"]["parent"] == "collection.compute"
    assert len(by_own["metric.update/MulticlassAUROC"]) == -(-rows // 64)
    # every span of the pass lies inside a collection span (the cost
    # model's first-sight capture is a measured duration, recorded flat)
    tops = [e for e in spans if "parent" not in e["labels"] and e["name"] != "obs.cost.capture"]
    assert {e["name"] for e in tops} == {"collection.reset", "collection.update", "collection.compute"}


def test_a_standalone_reset_has_its_span_and_nests_no_other():
    m = T.MulticlassAccuracy(device=CPU)
    m.update(torch.rand(8, 3), torch.randint(0, 3, (8,)))
    obs.enable()
    m.reset()
    assert [e["name"] for e in _spans()] == ["metric.reset/MulticlassAccuracy"]
    assert obs.snapshot()["spans"]["metric.reset/MulticlassAccuracy"]["count"] == 1


def _counted(monkeypatch, classes):
    """Count each class's ``_fold_fn`` calls (a vmapped call is one)."""
    calls = collections.Counter()
    for cls in classes:
        fn = cls._fold_fn

        def counting(*args, _fn=fn, _cls=cls):
            calls[_cls.__name__] += 1
            return _fn(*args)

        monkeypatch.setattr(cls, "_fold_fn", staticmethod(counting))
    return calls


@pytest.mark.parametrize("rows,batch", [(360, 64), (384, 64), (64, 64), (300, 300)])
def test_fold_calls_count_the_fold_fn_calls_made(monkeypatch, rows, batch):
    col = _imagenet_collection()
    _pass(col, rows, batch)
    classes = (T.MulticlassAccuracy, T.MulticlassF1Score, T.MulticlassConfusionMatrix)
    calls = _counted(monkeypatch, classes)
    obs.enable()
    _pass(col, rows, batch)
    assert count("deferred.fold_calls") == sum(calls.values()) > 0
    batches = -(-rows // batch)
    ragged = rows % batch != 0
    per_chunk = batches if ragged else 1
    assert calls["MulticlassAccuracy"] == 2 * per_chunk
    shape = "ragged" if ragged else ("stacked" if batches > 1 else "concat")
    # F1 and the confusion matrix fold the concatenated window: one call each
    concat = 2 + (2 if shape == "concat" else 0)
    assert count("deferred.fold_calls", shape="concat") == concat
    if shape != "concat":
        assert count("deferred.fold_calls", shape=shape) == 2 * per_chunk


def test_a_scan_member_counts_a_call_a_batch(monkeypatch):
    col = T.MetricCollection({
        "topk": T.TopKMultilabelAccuracy(k=2, device=CPU),
        "acc": T.MultilabelAccuracy(device=CPU),
    })
    g = torch.Generator().manual_seed(3)
    x, y = torch.rand(5, 16, 6, generator=g), torch.randint(0, 2, (5, 16, 6), generator=g)
    for i in range(5):
        col.update(x[i], y[i])
    calls = _counted(monkeypatch, (T.TopKMultilabelAccuracy,))
    obs.enable()
    col.compute()
    assert calls["TopKMultilabelAccuracy"] == 5
    assert count("deferred.fold_calls", shape="scan") == 5
    assert count("deferred.fold_calls", shape="stacked") == 1
    shapes = {e["labels"]["member"]: e["labels"]["shape"] for e in _spans()
              if _own(e).startswith("deferred.fold/") and "member" in e["labels"]}
    assert shapes == {"topk": "scan", "acc": "stacked"}


def test_a_ring_span_and_its_profiler_range_start_together():
    col = _imagenet_collection()
    _pass(col, 128, 64)
    obs.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # the profiler's first range pays its own set-up between the
        # range's start and the span's
        col.update(torch.rand(64, C), torch.randint(0, C, (64,)))
        for _ in range(20):
            col.update(torch.rand(64, C), torch.randint(0, C, (64,)))
    ranges = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "collection.update")[1:]
    ring = sorted(round(e["ts"] * 1e9) for e in _spans() if e["name"] == "collection.update")[1:]
    assert len(ranges) == len(ring) == 20
    gaps = [abs(a - b) for a, b in zip(ranges, ring)]
    assert max(gaps) < 200_000, gaps


def test_a_span_starts_where_its_range_does_whatever_its_enter_costs(monkeypatch):
    # a stall inside the span's own enter (where the interpreter may run a
    # due collection or hand the GIL to another thread) does not move the
    # span's start away from its range's
    entered = []

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append((self.name, time.perf_counter()))

        def __exit__(self, *exc):
            return None

    enter = registry._Span.__enter__

    def stalled(span):
        time.sleep(0.005)
        return enter(span)

    monkeypatch.setattr(annotate, "_record_function", Range)
    monkeypatch.setattr(annotate, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(registry._Span, "__enter__", stalled)
    obs.enable()
    assert annotate.spanned("probe.outer", {"k": 1}, annotate.spanned, "probe.inner", {}, int) == 0
    got = {_own(e): e for e in _spans()}
    starts = {_own(e): (ns - obs_trace._OFFSET_NS) / 1e9
              for e, (ns, *_) in zip(obs.timeline_events(), obs_trace._ring)}
    assert [n for n, _ in entered] == ["probe.inner", "probe.outer"][::-1]
    for name, t_range in entered:
        # read after the range's enter, and long before the stall's end
        assert -1e-6 < starts[name] - t_range < 0.001, (name, starts[name] - t_range)
    assert got["probe.outer"]["labels"] == {"k": "1"}
    assert got["probe.inner"]["labels"] == {"parent": "probe.outer"}
    assert got["probe.outer"]["dur"] > got["probe.inner"]["dur"] >= 0.005


def test_the_timeline_is_on_unix_time_and_monotonic():
    obs.enable()
    before = time.time()
    for i in range(50):
        obs_trace.instant("probe", i=i)
    after = time.time()
    ts = [e["ts"] for e in obs.timeline_events()]
    assert ts == sorted(ts)
    assert before - 0.01 <= ts[0] and ts[-1] <= after + 0.01
    # chrome_trace: microseconds of the same clock
    doc = json.loads(obs.chrome_trace())
    assert abs(doc["traceEvents"][0]["ts"] - ts[0] * 1e6) < 1.0


def test_the_ring_keeps_whole_ns_and_chrome_trace_exports_them():
    obs.enable()
    obs_trace.instant("probe")
    with obs.span("outer"):
        pass
    stamps = [e[0] for e in obs_trace._ring]
    assert all(isinstance(t, int) for t in stamps) and stamps == sorted(stamps)
    assert [e["ts"] for e in obs.timeline_events()] == [t / 1e9 for t in stamps]
    # the export's microseconds come from the ns, not from float seconds
    doc = json.loads(obs.chrome_trace())
    assert [e["ts"] for e in doc["traceEvents"]] == [round(t / 1e3, 3) for t in stamps]


def test_the_obs_cost_script_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "scripts/obs_cost_torch.py", "--cell", "imagenet1k_val_eval.b256"],
        capture_output=True, text=True, timeout=300, cwd=root,
    )
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_a_launch_counts_its_modelled_bytes_while_obs_is_enabled():
    labels = torch.arange(10, dtype=torch.int64) % 4
    out = torch.zeros(4, dtype=torch.int32)
    recompile.count_launch("hist", _hist_cost, (labels, 4), out)
    assert obs.snapshot()["counters"] == {}
    obs.enable()
    for _ in range(3):
        recompile.count_launch("hist", _hist_cost, (labels, 4), out)
    assert count("jit.calls", entry="hist") == 3
    assert count("obs.cost.launch_bytes", entry="hist") == 3 * (80 + 16)

    def broken(args, kwargs, out):
        raise RuntimeError("no model")

    recompile.count_launch("hist", broken, (labels, 4), out)
    assert count("jit.calls", entry="hist") == 4
    assert count("obs.cost.capture_errors", entry="hist") == 1
    assert count("obs.cost.launch_bytes", entry="hist") == 3 * 96


def test_no_watched_entry_lands_a_cache_hit_instant():
    col = _imagenet_collection()
    obs.enable()
    _pass(col, 256, 64)
    _pass(col, 256, 64)
    names = {e["name"] for e in obs.timeline_events()}
    assert "watched_jit.trace" in names
    assert not [n for n in names if "cache_hit" in n]
