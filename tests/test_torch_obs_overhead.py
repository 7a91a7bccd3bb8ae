"""The disabled path costs nothing: ``MetricCollection.update()`` on the
armed fast path (the steady state of every eval loop) does no obs work
while obs is disabled. No timeline append, no registry record, and no
allocation made inside ``torcheval_tpu_torch/obs/`` (``tracemalloc``), with
every obs module imported, ``stream``, ``slo``, ``httpd`` and
``distributed`` included. The window's labels are built behind call-site
``if _obs._enabled`` guards. The cases mirror
``tests/obs/test_host_overhead.py``; the same holds for a whole pass,
``reset()`` and the window step's per-member fold and compute sites
included, with a ragged last batch and without.
"""

import time
import tracemalloc
from pathlib import Path
from unittest import mock

import pytest
import torch

import torcheval_tpu_torch.obs as obs_pkg
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.metrics import (
    BinaryAccuracy,
    MeanSquaredError,
    MetricCollection,
    MulticlassAccuracy,
    MulticlassF1Score,
)
from torcheval_tpu_torch.obs import annotate, distributed, httpd, registry, slo, stream, trace  # noqa: F401

OBS_DIR = str(Path(obs_pkg.__file__).resolve().parent)


def _armed_collection():
    col = MetricCollection({
        "acc": MulticlassAccuracy(num_classes=5, device="cpu"),
        "f1": MulticlassF1Score(num_classes=5, average="macro", device="cpu"),
    })
    scores, labels = torch.rand(64, 5), torch.randint(0, 5, (64,))
    # the first update validates and arms the window's fast path
    col.update(scores, labels)
    col.update(scores, labels)
    return col, scores, labels


@pytest.fixture(autouse=True)
def _clean():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def test_no_ring_append_and_no_registry_record():
    col, scores, labels = _armed_collection()
    reg = registry.default_registry
    with mock.patch.object(trace, "_append", side_effect=AssertionError("ring append")), \
            mock.patch.object(reg, "counter", side_effect=AssertionError("counter")), \
            mock.patch.object(reg, "gauge", side_effect=AssertionError("gauge")), \
            mock.patch.object(reg, "histo", side_effect=AssertionError("histo")), \
            mock.patch.object(reg, "_record_span", side_effect=AssertionError("span")):
        for _ in range(50):
            col.update(scores, labels)
    assert trace.event_count() == 0
    assert len(col._window.chunks) == 52


def test_zero_allocations_inside_the_obs_modules():
    col, scores, labels = _armed_collection()
    for _ in range(5):  # warm any lazy cache on the measured path
        col.update(scores, labels)
    tracemalloc.start(25)
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(50):
            col.update(scores, labels)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    # the allocation site is the newest frame: the window's own appends
    # pass through the annotation wrapper's frame, which allocates nothing
    grew = [d for d in after.compare_to(before, "traceback")
            if d.size_diff > 0 and d.traceback[-1].filename.startswith(OBS_DIR)]
    assert grew == [], "; ".join(str(d) for d in grew)


def test_the_same_path_records_once_enabled():
    col, scores, labels = _armed_collection()
    obs.enable()
    col.update(scores, labels)
    names = [e["name"] for e in obs.timeline_events()]
    assert "deferred.window.append" in names
    assert obs.snapshot()["spans"]["collection.update"]["count"] == 1


def test_armed_update_stays_cheap():
    # a tripwire for an accidental millisecond-scale hook, not a benchmark
    col, scores, labels = _armed_collection()
    for _ in range(10):
        col.update(scores, labels)
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(20):
            col.update(scores, labels)
        times.append((time.perf_counter() - t0) / 20)
    assert sorted(times)[len(times) // 2] < 1e-3


def _pass_collection(float_member=False):
    if float_member:
        # a float sum keeps the call a batch of a ragged window (``ragged``)
        col = MetricCollection({
            "acc": BinaryAccuracy(device="cpu"),
            "mse": MeanSquaredError(device="cpu"),
        })
        return col, torch.rand(200), torch.randint(0, 2, (200,)).float()
    col = MetricCollection({
        "top1": MulticlassAccuracy(device="cpu"),
        "top5": MulticlassAccuracy(k=3, device="cpu"),
        "f1": MulticlassF1Score(num_classes=5, average="macro", device="cpu"),
    })
    scores, labels = torch.rand(200, 5), torch.randint(0, 5, (200,))
    return col, scores, labels


def _whole_pass(col, scores, labels, batch):
    col.reset()
    for s in range(0, scores.shape[0], batch):
        col.update(scores[s:s + batch], labels[s:s + batch])
    return col.compute()


# 200 rows in batches of 64 end ragged (8 rows); of 40, uniform (stacked)
PASSES = pytest.mark.parametrize(
    "batch,float_member", [(64, False), (40, False), (64, True)], ids=["ragged", "uniform", "ragged-float"]
)


@PASSES
def test_a_pass_with_reset_and_window_step_records_nothing(batch, float_member):
    col, scores, labels = _pass_collection(float_member)
    _whole_pass(col, scores, labels, batch)  # arms the window
    reg = registry.default_registry
    with mock.patch.object(trace, "_append", side_effect=AssertionError("ring append")), \
            mock.patch.object(reg, "counter", side_effect=AssertionError("counter")), \
            mock.patch.object(reg, "histo", side_effect=AssertionError("histo")), \
            mock.patch.object(reg, "_record_span", side_effect=AssertionError("span")), \
            mock.patch.object(reg, "span", side_effect=AssertionError("span")):
        for _ in range(3):
            _whole_pass(col, scores, labels, batch)
    assert trace.event_count() == 0


@PASSES
def test_a_pass_with_reset_and_window_step_allocates_nothing_inside_obs(batch, float_member):
    col, scores, labels = _pass_collection(float_member)
    for _ in range(2):  # warm any lazy cache on the measured path
        _whole_pass(col, scores, labels, batch)
    tracemalloc.start(25)
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(5):
            _whole_pass(col, scores, labels, batch)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grew = [d for d in after.compare_to(before, "traceback")
            if d.size_diff > 0 and d.traceback[-1].filename.startswith(OBS_DIR)]
    assert grew == [], "; ".join(str(d) for d in grew)


@PASSES
def test_the_pass_records_its_spans_once_enabled(batch, float_member):
    col, scores, labels = _pass_collection(float_member)
    _whole_pass(col, scores, labels, batch)
    obs.enable()
    _whole_pass(col, scores, labels, batch)
    spans = obs.snapshot()["spans"]
    window = "collection.compute/jit/deferred.window_step"
    assert spans["collection.reset"]["count"] == 1
    assert spans[f"{window}/deferred.operands"]["count"] == 1
    if float_member:
        # each member's fold and its combine
        assert spans[f"{window}/deferred.fold/MeanSquaredError{{member=mse,shape=ragged}}"]["count"] == 2
        assert spans[f"{window}/deferred.fold/BinaryAccuracy{{member=acc,shape=concat}}"]["count"] == 2
        return
    assert spans[f"{window}/deferred.compute_fn/MulticlassF1Score{{member=f1}}"]["count"] == 1
    # a ragged window's accuracies (exact counts) fold its concatenation
    shape = "concat" if batch == 64 else "stacked"
    folds = 2 if batch == 64 else 1  # a concat member's fold and its combine
    assert spans[f"{window}/deferred.fold/MulticlassAccuracy{{member=top1,shape={shape}}}"]["count"] == folds
    assert (f"{window}/deferred.fold/stacked{{members=2,shape=stacked}}" in spans) == (batch == 40)
