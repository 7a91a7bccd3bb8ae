"""The disabled path costs nothing: ``MetricCollection.update()`` on the
armed fast path (the steady state of every eval loop) does no obs work
while obs is disabled. No timeline append, no registry record, and no
allocation made inside ``torcheval_tpu_torch/obs/`` (``tracemalloc``), with
every obs module imported, ``stream``, ``slo``, ``httpd`` and
``distributed`` included. The window's labels are built behind call-site
``if _obs._enabled`` guards. The cases mirror
``tests/obs/test_host_overhead.py``.
"""

import time
import tracemalloc
from pathlib import Path
from unittest import mock

import pytest
import torch

import torcheval_tpu_torch.obs as obs_pkg
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.metrics import MetricCollection, MulticlassAccuracy, MulticlassF1Score
from torcheval_tpu_torch.obs import distributed, httpd, registry, slo, stream, trace  # noqa: F401

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
