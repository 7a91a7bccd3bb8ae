"""``torcheval_tpu_torch/utils/telemetry.py`` against the JAX package's
``utils/telemetry.py``, and the port's once-per-key warnings built on it.

The same sequences of ``log_api_usage_once`` / ``log_once`` /
``reset_once_keys`` calls reach each package's sink and logger the same
number of times. Metric construction logs its class once per process
(``torcheval_tpu_torch.metrics.<class>``, the JAX package's
``torcheval_tpu.metrics.<class>``), and ``obs.reset()`` re-arms every key:
the approximate-mode notices (which lived in ``sketch/cache.py``), the
registry's label-cap warning (which lived in ``obs/registry.py``) and the
degraded-sync warning. The cases mirror ``tests/obs/test_telemetry.py`` and
``tests/obs/test_reset.py``.
"""

import logging

import pytest

import torcheval_tpu.metrics as J
from torcheval_tpu import obs as jax_obs
from torcheval_tpu.utils import telemetry as jax_telemetry
from torcheval_tpu_torch import obs
import torcheval_tpu_torch.metrics as T
from torcheval_tpu_torch.obs import registry
from torcheval_tpu_torch.utils import telemetry

CPU = "cpu"


class _Records(logging.Handler):
    def __init__(self, level=logging.DEBUG):
        super().__init__(level)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture
def logs():
    """Every record of the port's telemetry logger, DEBUG included."""
    logger = logging.getLogger("torcheval_tpu_torch.api_usage")
    handler, level = _Records(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    yield handler.messages
    logger.removeHandler(handler)
    logger.setLevel(level)


@pytest.fixture(autouse=True)
def _clean():
    for m in (telemetry, jax_telemetry):
        m.reset_once_keys()
        m.set_api_usage_sink(None)
    yield
    for m in (telemetry, jax_telemetry):
        m.reset_once_keys()
        m.set_api_usage_sink(None)
    obs.disable()
    obs.reset()


@pytest.mark.parametrize(
    "keys",
    [["a"], ["a", "a", "a"], ["a", "b", "a", "c", "b"], []],
    ids=["one", "repeated", "mixed", "none"],
)
def test_usage_keys_reach_the_sink_once_in_both_packages(keys):
    seen = {}
    for name, m in (("port", telemetry), ("jax", jax_telemetry)):
        got = []
        m.set_api_usage_sink(got.append)
        for k in keys:
            m.log_api_usage_once(k)
        m.reset_once_keys("a")
        for k in keys:
            m.log_api_usage_once(k)
        seen[name] = got
    assert seen["port"] == seen["jax"]


def test_a_broken_sink_never_raises_and_consumes_its_key():
    def broken(_key):
        raise RuntimeError("sink down")

    telemetry.set_api_usage_sink(broken)
    telemetry.log_api_usage_once("k")
    got = []
    telemetry.set_api_usage_sink(got.append)
    telemetry.log_api_usage_once("k")
    assert got == []


def test_metric_construction_logs_its_class_once(logs):
    sinks = {"port": [], "jax": []}
    telemetry.set_api_usage_sink(sinks["port"].append)
    jax_telemetry.set_api_usage_sink(sinks["jax"].append)
    for _ in range(3):
        T.MulticlassAccuracy(num_classes=3, device=CPU)
        T.BinaryAUROC(device=CPU)
        J.MulticlassAccuracy(num_classes=3)
        J.BinaryAUROC()
    assert sinks["port"] == [
        "torcheval_tpu_torch.metrics.MulticlassAccuracy",
        "torcheval_tpu_torch.metrics.BinaryAUROC",
    ]
    assert [k.replace("torcheval_tpu.", "torcheval_tpu_torch.", 1) for k in sinks["jax"]] == sinks["port"]
    assert logs.count("API usage: torcheval_tpu_torch.metrics.BinaryAUROC") == 1


def test_log_once_is_rearmed_by_obs_reset(logs):
    for _ in range(3):
        telemetry.log_once("probe", "warned %d", 1)
    assert logs == ["warned 1"]
    obs.reset()
    telemetry.log_once("probe", "warned %d", 2)
    assert logs == ["warned 1", "warned 2"]


def test_obs_reset_rearms_the_keys_in_both_packages():
    fired = {}
    for name, m, o in (("port", telemetry, obs), ("jax", jax_telemetry, jax_obs)):
        got = []
        m.set_api_usage_sink(got.append)
        m.log_api_usage_once("usage")
        m.log_api_usage_once("usage")
        o.reset()
        m.log_api_usage_once("usage")
        fired[name] = got
    assert fired["port"] == fired["jax"] == ["usage", "usage"]


def test_the_approx_notice_fires_once_until_a_reset(monkeypatch, logs):
    monkeypatch.setenv("TORCHEVAL_TPU_APPROX", "1")
    for _ in range(3):
        T.Cat(dim=1, device=CPU)
    notices = [m for m in logs if "cannot sketch" in m]
    assert len(notices) == 1
    obs.reset()
    T.Cat(dim=1, device=CPU)
    assert len([m for m in logs if "cannot sketch" in m]) == 2


def test_the_label_cap_warning_fires_once_per_name_until_a_reset(logs):
    obs.enable()
    prev = registry.set_label_cardinality_cap(2)
    try:
        for i in range(5):
            obs.counter("capped", tenant=str(i))
        warned = [m for m in logs if "'capped' exceeded" in m]
        assert len(warned) == 1
        assert obs.snapshot()["counters"]["obs.labels.dropped{instrument=capped}"] == 3.0
        obs.reset()
        for i in range(5):
            obs.counter("capped", tenant=str(i))
        assert len([m for m in logs if "'capped' exceeded" in m]) == 2
    finally:
        registry.set_label_cardinality_cap(prev)
