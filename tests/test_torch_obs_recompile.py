"""``torcheval_tpu_torch/obs/{recompile,cost}.py`` (``watched``, the cost
gauges) against the JAX package's ``watched_jit`` and ``obs/cost.py``.

A drifting-shape loop goes through the port's ``hist`` and the JAX
package's ``pallas_class_counts(interpret=True)`` with obs enabled on both
sides: the same calls are first sights of a signature
(``recompile.traces{entry=}``), the per-entry trace counts agree, and the
storm warning fires on the same call, once. The port's watchdog runs only
while obs is enabled (the module's documented difference: eager PyTorch has
no cache miss to hook). The cases mirror ``tests/obs/test_recompile.py`` and
``tests/obs/test_cost.py``.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu import obs as jax_obs
from torcheval_tpu.obs import recompile as jax_recompile
from torcheval_tpu.ops.pallas_hist import pallas_class_counts
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.obs import recompile
from torcheval_tpu_torch.obs.inventory import ENTRIES
from torcheval_tpu_torch.ops.confusion import class_counts
from torcheval_tpu_torch.ops.hist import hist
from torcheval_tpu_torch.ops.scatter import segment_sum
from torcheval_tpu_torch.ops.stream_compact import compact_summary_rows
from torcheval_tpu_torch.utils.test_utils.obs_counts import count, launches


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture(autouse=True)
def _clean():
    thresholds = (recompile.retrace_threshold(), jax_recompile.retrace_threshold())
    for m in (obs, jax_obs):
        m.disable()
        m.reset()
    yield
    for m in (obs, jax_obs):
        m.disable()
        m.reset()
    recompile.set_retrace_threshold(thresholds[0])
    jax_recompile.set_retrace_threshold(thresholds[1])


def _traces(module, entry):
    counters = module.snapshot()["counters"]
    return counters.get(f"recompile.traces{{entry={entry}}}", 0.0)


@pytest.mark.parametrize("threshold", [3, 8])
def test_drifting_shapes_match_the_jax_watchdog(threshold):
    obs.enable()
    jax_obs.enable()
    recompile.set_retrace_threshold(threshold)
    jax_recompile.set_retrace_threshold(threshold)
    rng = np.random.default_rng(0)
    # shapes of their own per case: a JAX program stays compiled across
    # obs.reset(), so a shape seen before is no trace there
    drift = (16, 16, 17, 18, 16, 19, 20, 21, 17, 22, 23, 24, 25, 26, 16, 27)
    sizes = [threshold * 100 + d for d in drift]
    port_log, jax_log = _Records(), _Records()
    loggers = (logging.getLogger("torcheval_tpu_torch.api_usage"),
               logging.getLogger("torcheval_tpu.api_usage"))
    loggers[0].addHandler(port_log)
    loggers[1].addHandler(jax_log)
    firsts, storms = {"port": [], "jax": []}, {"port": [], "jax": []}
    try:
        for n in sizes:
            labels = rng.integers(-1, 6, n).astype(np.int32)
            before = (_traces(obs, "hist"), _traces(jax_obs, "pallas_class_counts"))
            got = hist(torch.from_numpy(labels), 5)
            want = pallas_class_counts(jnp.asarray(labels), num_classes=5, interpret=True)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            firsts["port"].append(_traces(obs, "hist") - before[0])
            firsts["jax"].append(_traces(jax_obs, "pallas_class_counts") - before[1])
            storms["port"].append(sum("Retrace storm" in m for m in port_log.messages))
            storms["jax"].append(sum("Retrace storm" in m for m in jax_log.messages))
    finally:
        loggers[0].removeHandler(port_log)
        loggers[1].removeHandler(jax_log)
    assert firsts["port"] == firsts["jax"]
    assert storms["port"] == storms["jax"]
    assert storms["port"][-1] == 1
    port_counts = obs.trace_counts()["hist"]
    jax_counts = jax_obs.trace_counts()["pallas_class_counts"]
    assert port_counts == jax_counts == {"traces": len(set(sizes)), "distinct_signatures": len(set(sizes))}
    assert ENTRIES["hist"] == "pallas_class_counts"


def test_the_watchdog_runs_only_while_obs_is_enabled():
    hist(torch.tensor([0, 1, 1]), 3)
    assert obs.trace_counts() == {}
    assert obs.snapshot()["counters"] == {}
    obs.enable()
    hist(torch.tensor([0, 1, 1]), 3)
    assert obs.trace_counts()["hist"] == {"traces": 1, "distinct_signatures": 1}


def test_python_scalars_are_static_and_tensors_dynamic():
    static, dynamic = recompile.split_signature((torch.zeros(3, 2), 5), {"k": 2.0})
    assert dynamic == (((3, 2), "torch.float32"),)
    assert static[1] == (5, 2.0)
    # a new static value is a new program, not a retrace of the old one
    obs.enable()
    recompile.set_retrace_threshold(2)
    for c in range(2, 6):
        hist(torch.tensor([0, 1]), c)
    assert obs.trace_counts()["hist"]["distinct_signatures"] == 4
    assert count("recompile.traces", entry="hist") == 4


def test_kernel_entries_count_launches_and_every_other_entry_its_calls():
    obs.enable()
    labels = torch.tensor([0, 1, 1, 3])
    for _ in range(3):
        class_counts(labels, 4)
    # a CPU tensor runs the plain version: no launch
    assert launches("hist") == 0
    assert count("jit.calls", entry="class_counts") == 3
    assert count("recompile.traces", entry="class_counts") == 1
    events = [e["name"] for e in obs.timeline_events()]
    assert events.count("watched_jit.trace") == 2  # class_counts and hist, once each
    spans = obs.snapshot()["spans"]
    assert spans["jit/class_counts"]["count"] == 3
    assert spans["jit/class_counts/jit/hist"]["count"] == 3
    # no kernel build on the CPU: no compile span
    assert not [k for k in spans if k.startswith("jit.compile/")]


def test_cost_gauges_on_the_first_sight_of_each_signature():
    obs.enable()
    labels = torch.zeros(1000, dtype=torch.int64)
    hist(labels, 7)
    hist(labels, 7)
    g = obs.snapshot()["gauges"]
    assert g["obs.cost.bytes_accessed{entry=hist}"] == 1000 * 8 + 7 * 4
    assert g["obs.cost.flops{entry=hist}"] == 0.0
    assert obs.snapshot()["counters"]["obs.cost.captures{entry=hist}"] == 1.0
    vals = torch.ones((50, 3), dtype=torch.float32)
    rows = torch.zeros(50, dtype=torch.int64)
    segment_sum(vals, rows, 4)
    g = obs.snapshot()["gauges"]
    assert g["obs.cost.bytes_accessed{entry=segment_sum}"] == 50 * 3 * 4 + 50 * 8 + 4 * 3 * 4
    assert g["obs.cost.flops{entry=segment_sum}"] == 150.0
    n = 64
    keep = torch.rand(n) < 0.5
    s, t = torch.rand(n), torch.ones(n, dtype=torch.int32)
    compact_summary_rows(s, t, t, keep)
    g = obs.snapshot()["gauges"]
    # the mask, three 4-byte columns in and out, and the count: phase 5's bound
    assert g["obs.cost.bytes_accessed{entry=compact_summary_rows}"] == n * (1 + 12 + 12) + 4
    assert g["obs.cost.bytes_accessed{entry=stream_compact}"] == n * (1 + 12 + 12) + 4
    # library entries carry no cost gauges
    assert not [k for k in g if "entry=class_counts" in k]


def test_reset_clears_the_bookkeeping_and_rearms_the_warning():
    obs.enable()
    recompile.set_retrace_threshold(2)
    handler = _Records()
    logger = logging.getLogger("torcheval_tpu_torch.api_usage")
    logger.addHandler(handler)
    try:
        for n in (3, 4, 5):
            hist(torch.zeros(n, dtype=torch.int32), 2)
        assert sum("Retrace storm" in m for m in handler.messages) == 1
        obs.reset()
        assert obs.trace_counts() == {}
        hist(torch.zeros(3, dtype=torch.int32), 2)  # a first sight again
        assert count("recompile.traces", entry="hist") == 1
        hist(torch.zeros(4, dtype=torch.int32), 2)
        assert sum("Retrace storm" in m for m in handler.messages) == 2
    finally:
        logger.removeHandler(handler)
    with pytest.raises(ValueError):
        recompile.set_retrace_threshold(1)


def test_the_bookkeeping_keeps_no_argument_alive():
    import gc
    import weakref

    import torcheval_tpu_torch.metrics as T

    obs.enable()
    m = T.MulticlassAccuracy(num_classes=3, device="cpu")
    m.update(torch.rand(8, 3), torch.randint(0, 3, (8,))).compute()  # a watched fold of m
    ref = weakref.ref(m)
    static, _ = recompile.split_signature(((m,), [torch.zeros(2)]), {})
    assert static[1] == ("MulticlassAccuracy",)  # a metric stands by its class
    del m
    gc.collect()
    assert ref() is None
    assert count("recompile.traces", entry="deferred.window_step") == 1


def test_watched_keeps_the_function_and_names_its_entry():
    assert hist.__name__ == "hist" and "int32 counts" in hist.__doc__
    assert hist.__obs_entry__ == "hist"
    assert class_counts.__obs_entry__ == "class_counts"

    @obs.watched
    def double(x):
        return x * 2

    obs.enable()
    assert double(torch.ones(2)).tolist() == [2.0, 2.0]
    assert double.__obs_entry__.endswith("double")
    assert count("jit.calls", entry=double.__obs_entry__) == 1
