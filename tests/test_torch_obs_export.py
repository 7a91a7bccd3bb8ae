"""``torcheval_tpu_torch/obs/{export,stream,slo}.py`` against the JAX
package's ``obs/{export,stream,slo}.py``.

The same sequence of counter, gauge, histogram and span calls (generated by
hypothesis, with measured span seconds so that both sides hold the same
numbers) goes into a fresh ``Registry`` of each package. Then:

* ``prometheus_text()`` and ``to_json()`` are byte-identical;
* ``collect()`` deltas over the same split of the sequence are equal, and
  a ``DeltaAccumulator`` fed them gives equal snapshots, equal to the
  registry's own snapshot;
* SLO evaluations with the clock injected give equal results, registry
  records and alarm payloads (their wall-clock ``ts`` aside).

The cases mirror ``tests/obs/test_registry.py`` (export),
``tests/obs/test_delta.py`` and ``tests/obs/test_slo.py``.
"""

import json
import math

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from torcheval_tpu import obs as jax_obs
from torcheval_tpu.obs import export as jax_export
from torcheval_tpu.obs import registry as jax_registry
from torcheval_tpu.obs import slo as jax_slo
from torcheval_tpu.obs import stream as jax_stream
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.obs import export, registry, slo, stream

NAMES = ("sync.rounds", "bytes", "serve.submit.latency", "lat", "a/b", "x-y z")
LABEL_KEYS = ("lane", "tenant", "entry")
LABEL_VALUES = ("SUM", "a", 'q"uote', "back\\slash", "new\nline", "")
FLOATS = st.one_of(
    st.floats(min_value=-1e12, max_value=1e12, allow_nan=False),
    st.sampled_from([0.0, 1.0, 2.0**-27, 2.0**36, math.inf, -math.inf, 1e-9, 0.25]),
)


def _labels():
    return st.dictionaries(st.sampled_from(LABEL_KEYS), st.sampled_from(LABEL_VALUES), max_size=2)


CALL = st.one_of(
    # a counter moves by a positive delta (a zero move ships no delta in
    # either package, so the accumulated view would lack the series)
    st.tuples(st.just("counter"), st.sampled_from(NAMES), st.floats(1e-3, 1e9), _labels()),
    st.tuples(st.just("gauge"), st.sampled_from(NAMES), FLOATS, _labels()),
    st.tuples(st.just("histo"), st.sampled_from(NAMES), FLOATS, _labels()),
    st.tuples(st.just("span"), st.sampled_from(NAMES), st.floats(0, 100), _labels()),
)


def _apply(reg, calls):
    for kind, name, value, labels in calls:
        if kind == "span":
            reg.observe_span(name, value, **labels)
        else:
            getattr(reg, kind)(name, value, **labels)


@pytest.fixture(autouse=True)
def _clean():
    for m in (obs, jax_obs):
        m.disable()
        m.reset()
    yield
    slo._reset_for_tests()
    jax_slo._reset_for_tests()
    for m in (obs, jax_obs):
        m.disable()
        m.reset()


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(CALL, max_size=40))
def test_prometheus_text_and_json_are_byte_identical(calls):
    port, ref = registry.Registry(), jax_registry.Registry()
    _apply(port, calls)
    _apply(ref, calls)
    assert export.prometheus_text(port) == jax_export.prometheus_text(ref)
    assert export.to_json(port) == jax_export.to_json(ref)
    assert export.to_json(port, indent=2) == jax_export.to_json(ref, indent=2)


def test_export_defaults_to_the_default_registry():
    obs.enable()
    jax_obs.enable()
    for m in (obs, jax_obs):
        m.counter("toolkit.sync.rounds", 2)
        m.histo("toolkit.sync.round_seconds", 0.5, lane="typed")
    assert obs.prometheus_text() == jax_obs.prometheus_text()
    assert json.loads(obs.to_json()) == json.loads(jax_obs.to_json())
    assert "# TYPE toolkit_sync_round_seconds histogram" in obs.prometheus_text()


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.lists(CALL, max_size=12), min_size=1, max_size=5))
def test_deltas_and_their_accumulation_match(ticks):
    port, ref = registry.Registry(), jax_registry.Registry()
    acc, jacc = stream.DeltaAccumulator(), jax_stream.DeltaAccumulator()
    cur = jcur = None
    for calls in ticks:
        _apply(port, calls)
        _apply(ref, calls)
        delta, cur = stream.collect(cur, registry=port, include_events=False)
        jdelta, jcur = jax_stream.collect(jcur, registry=ref, include_events=False)
        assert json.dumps(delta, sort_keys=True, default=str) == json.dumps(
            jdelta, sort_keys=True, default=str
        )
        assert stream.delta_nbytes(delta) == jax_stream.delta_nbytes(jdelta)
        acc.apply(delta)
        jacc.apply(jdelta)
        assert acc.snapshot() == jacc.snapshot()
    # folding every delta gives the registry's own snapshot
    assert acc.snapshot() == port.snapshot()


def test_a_reset_sends_a_full_delta_and_rewinds_the_events():
    obs.enable()
    jax_obs.enable()
    out = []
    for m, s in ((obs, stream), (jax_obs, jax_stream)):
        m.counter("a", 1)
        with m.span("s"):
            pass
        d0, cur = s.collect()
        m.reset()
        m.counter("a", 2)
        d1, cur = s.collect(cur)
        out.append((d0["full"], d1["full"], d1["counters"], [e["name"] for e in d1["events"]],
                    [e["name"] for e in d0["events"]]))
    assert out[0] == out[1]


def _slo_run(mod, reg, events):
    """Evaluate one objective over a scripted clock; every alarm payload
    without its wall-clock stamp."""
    fired = []

    def hook(payload):
        fired.append({k: v for k, v in payload.items() if k != "ts"})

    mod.on_alarm(hook)
    objective = mod.register_slo(
        mod.Slo("submit_p99", instrument="lat", threshold_s=0.25, window_s=10.0, budget=0.1)
    )
    results = []
    try:
        for t, values in events:
            for tenant, v in values:
                reg.histo("lat", v, tenant=tenant)
            results.append(mod.evaluate_slos(registry=reg, now=t))
    finally:
        mod.remove_alarm(hook)
        mod.unregister_slo(objective)
    return results, fired, reg.snapshot()


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    st.lists(
        st.tuples(
            st.floats(0.1, 5.0),
            st.lists(st.tuples(st.sampled_from(("a", "b")), st.floats(0.0, 2.0)), max_size=6),
        ),
        max_size=8,
    )
)
def test_slo_evaluations_and_alarms_match(steps):
    t, events = 0.0, []
    for dt, values in steps:
        t += dt
        events.append((t, values))
    got = _slo_run(slo, registry.Registry(), events)
    want = _slo_run(jax_slo, jax_registry.Registry(), events)
    assert got == want


def test_a_raising_alarm_callback_is_dropped_and_the_rest_fire():
    seen = []

    def bad(_payload):
        raise RuntimeError("boom")

    obs.on_alarm(bad)
    obs.on_alarm(seen.append)
    obs.fire_alarm({"kind": "drift.alarm"})
    assert seen == [{"kind": "drift.alarm"}]
    obs.remove_alarm(bad)
    obs.remove_alarm(seen.append)
    with pytest.raises(ValueError):
        slo.Slo("x", instrument="lat", threshold_s=0.0)
