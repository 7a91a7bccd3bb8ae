"""``torcheval_tpu_torch/obs/annotate.py`` against the JAX package's
``obs/annotate.py``: every metric's ``update``/``compute``/``merge_state``
records a span named by the runtime class, with the same names as the JAX
package's for the same calls; the collection, the evaluator and the toolkit
entry points carry the JAX names; under ``torch.profiler`` on the CPU the
plain versions' ops fall inside ``metric.update/<cls>``; under a
``torch.func`` transform the range stands alone, with no span. The cases
mirror ``tests/obs/test_annotate.py``.
"""

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
from torcheval_tpu import obs as jax_obs
import torcheval_tpu_torch.metrics as T
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.metrics import toolkit
from torcheval_tpu_torch.obs.annotate import _under_transform, instrument_protocol, traced
from torcheval_tpu_torch.ops.confusion import class_counts

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean():
    for m in (obs, jax_obs):
        m.disable()
        m.reset()
    yield
    for m in (obs, jax_obs):
        m.disable()
        m.reset()


def _metric_spans(module):
    """The per-metric span paths (the kernels' nested entries aside, whose
    names are each package's own)."""
    return {k: v["count"] for k, v in module.snapshot()["spans"].items()
            if k.startswith("metric.") and "/jit" not in k}


def test_span_names_follow_the_runtime_class_in_both_packages():
    obs.enable()
    jax_obs.enable()
    rng = np.random.default_rng(0)
    scores, labels = rng.random((64, 4)).astype(np.float32), rng.integers(0, 4, 64)
    x, t = rng.random(64).astype(np.float32), (rng.random(64) < 0.4).astype(np.float32)
    for mod, kw in ((T, {"device": CPU}), (J, {})):
        acc = mod.MulticlassAccuracy(num_classes=4, **kw)
        auroc = mod.BinaryAUROC(**kw)
        other = mod.BinaryAUROC(**kw)
        for _ in range(3):
            acc.update(scores, labels)
            auroc.update(x, t)
        other.update(x, t)
        auroc.merge_state([other])
        acc.compute()
        auroc.compute()
    got, want = _metric_spans(obs), _metric_spans(jax_obs)
    assert got == want
    assert got["metric.update/BinaryAUROC"] == 4 and got["metric.merge_state/BinaryAUROC"] == 1


def test_a_user_subclass_is_annotated_under_its_own_name():
    class MySum(T.Sum):
        pass

    obs.enable()
    MySum(device=CPU).update(torch.tensor([1.0, 2.0])).compute()
    spans = obs.snapshot()["spans"]
    assert spans["metric.update/MySum"]["count"] == 1
    assert "metric.update/Sum" not in spans
    # the protocol's docstring follows the wrapper
    assert T.BinaryAUROC.update.__doc__ and T.BinaryAUROC.update.__obs_wrapped__


def test_instrument_protocol_wraps_each_definition_once():
    class Base(T.Sum):
        def update(self, x):
            return super().update(x)

    first = Base.update
    instrument_protocol(Base)
    assert Base.update is first  # already wrapped where it lives


def test_collection_evaluator_and_toolkit_names():
    obs.enable()
    rng = np.random.default_rng(1)
    scores, labels = torch.from_numpy(rng.random((32, 3)).astype(np.float32)), torch.from_numpy(
        rng.integers(0, 3, 32))
    col = T.MetricCollection({"acc": T.MulticlassAccuracy(num_classes=3, device=CPU)})
    col.update(scores, labels)
    col.compute()
    toolkit.sync_and_compute(T.Sum(device=CPU).update(torch.ones(2)))
    spans = obs.snapshot()["spans"]
    assert spans["collection.update"]["count"] == 1
    assert spans["collection.compute"]["count"] == 1
    assert "toolkit.sync_and_compute" in spans
    assert "toolkit.sync_and_compute/toolkit.get_synced_metric" in spans


def test_plain_ops_fall_inside_the_metric_range_under_the_profiler():
    obs.enable()
    rng = np.random.default_rng(2)
    auroc = T.BinaryAUROC(compaction_threshold=300, device=CPU)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            auroc.update(torch.from_numpy(rng.random(100).astype(np.float32)),
                         torch.from_numpy((rng.random(100) < 0.5).astype(np.float32)))
    events = prof.events()

    def ancestors(e):
        out = []
        while e.cpu_parent is not None:
            e = e.cpu_parent
            out.append(e.name)
        return out

    nonzero = [e for e in events if e.name == "aten::nonzero"]  # the compaction's plain version
    assert nonzero
    for e in nonzero:
        chain = ancestors(e)
        assert "metric.update/BinaryAUROC" in chain and "jit/compact_summary_rows" in chain
    ranges = [e for e in events if e.name == "metric.update/BinaryAUROC"]
    assert len(ranges) == 4


def test_under_a_transform_the_range_stands_alone():
    obs.enable()
    labels = torch.tensor([[0, 1, 1], [2, 2, 0]])
    got = torch.func.vmap(lambda x: class_counts(x, 3))(labels)
    assert got.tolist() == [[1, 2, 0], [1, 0, 2]]
    spans = obs.snapshot()["spans"]
    assert not [k for k in spans if "class_counts" in k]
    assert not _under_transform((labels,))
    torch.func.vmap(lambda x: _check_under(x))(labels)


def _check_under(x):
    assert _under_transform((x,))
    return x


def test_traced_is_one_read_while_disabled():
    calls = []

    @traced("probe.entry")
    def probe(a, b=0):
        calls.append((a, b))
        return a + b

    assert probe(1, b=2) == 3 and probe.__obs_wrapped__ is not None
    assert obs.snapshot()["spans"] == {}
    obs.enable()
    probe(2)
    assert obs.snapshot()["spans"]["probe.entry"]["count"] == 1
    assert calls == [(1, 2), (2, 0)]
