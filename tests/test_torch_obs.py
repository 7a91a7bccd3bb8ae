"""``torcheval_tpu_torch/obs`` (the registry and the event timeline) against
the JAX package's ``obs/registry.py`` and ``obs/trace.py``: the same
sequence of counters, gauges, histograms and nested spans gives the same
``snapshot()`` keys, counts and log2 bucket indices in both packages (span
seconds excepted: they are wall time), and ``chrome_trace()`` keeps the JAX
schema. The cases mirror ``tests/obs/test_registry.py`` and
``tests/obs/test_trace.py``."""

import json
import math
import threading
import time

import pytest

from torcheval_tpu import obs as jax_obs
from torcheval_tpu.obs import registry as jax_registry
from torcheval_tpu.obs import trace as jax_trace
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.obs import registry
from torcheval_tpu_torch.obs import trace

EMPTY = {"counters": {}, "gauges": {}, "histograms": {}, "spans": {}}
VALUES = (1e-9, 3e-7, 0.001, 0.25, 0.5, 1.0, 7.0, 1e6, 2.0**-27, 2.0**36, 0.0, -1.0,
          math.inf, -math.inf, math.nan)


@pytest.fixture(autouse=True)
def _clean():
    for m, t in ((obs, trace), (jax_obs, jax_trace)):
        m.disable()
        m.reset()
    caps = (trace.capacity(), jax_trace.capacity())
    yield
    for m in (obs, jax_obs):
        m.disable()
        m.reset()
    trace.set_capacity(caps[0])
    jax_trace.set_capacity(caps[1])


def _drive(reg):
    """One sequence of every instrument, with labels and nesting."""
    reg.counter("sync.rounds", 2)
    reg.counter("bytes", 10, lane="SUM")
    reg.counter("bytes", 5, lane="CAT")
    reg.counter("bytes", 1, lane="SUM")
    reg.gauge("world", 4)
    reg.gauge("world", 8)
    reg.gauge("depth", 3, tenant="a")
    for v in VALUES:
        reg.histo("lat", v)
    reg.histo("rt", 1.0, lane="typed")
    reg.histo("rt", 1.0, lane="object")
    reg.observe_span("measured", 0.003, lane="typed")
    with reg.span("outer", tag="t"):
        with reg.span("inner"):
            pass
        with reg.span("inner"):
            pass
    with pytest.raises(RuntimeError):
        with reg.span("boom"):
            raise RuntimeError("x")
    with reg.span("after"):
        pass


def _without_seconds(snap):
    out = json.loads(json.dumps(snap))
    for s in out["spans"].values():
        for k in ("total_seconds", "max_seconds", "p50", "p95", "p99"):
            s.pop(k)
    return out


def _bucket_items(reg):
    """Histogram buckets exactly; span buckets only as a count (their
    indices follow wall time)."""
    out = []
    for kind, name, labels, value in reg._items():
        if kind == "span":
            out.append((kind, name, labels, value[0], sum(value[3])))
        else:
            out.append((kind, name, labels, value))
    return sorted(out, key=repr)


def test_snapshot_equals_jax_key_for_key():
    mine, theirs = registry.Registry(), jax_registry.Registry()
    _drive(mine)
    _drive(theirs)
    a, b = mine.snapshot(), theirs.snapshot()
    assert _without_seconds(a) == _without_seconds(b)
    assert a["histograms"] == b["histograms"]
    assert _bucket_items(mine) == _bucket_items(theirs)
    assert a["counters"]["bytes{lane=SUM}"] == 11 and a["gauges"]["world"] == 8.0
    assert a["spans"]["outer/inner"]["count"] == 2 and "inner" not in a["spans"]


def test_bucket_scheme_equals_jax():
    assert (registry.HISTOGRAM_MIN_EXP, registry.HISTOGRAM_BUCKETS) == (
        jax_registry.HISTOGRAM_MIN_EXP, jax_registry.HISTOGRAM_BUCKETS)
    vals = list(VALUES) + [2.0**e for e in range(-40, 50)] + [3 * 2.0**e for e in range(-30, 40)]
    assert [registry.bucket_index(v) for v in vals] == [jax_registry.bucket_index(v) for v in vals]
    for i in range(registry.HISTOGRAM_BUCKETS):
        assert registry.bucket_upper_edge(i) == jax_registry.bucket_upper_edge(i)
    counts = [0, 3, 0, 1, 5] + [0] * (registry.HISTOGRAM_BUCKETS - 5)
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert registry.percentile_from_buckets(counts, 9, q) == jax_registry.percentile_from_buckets(
            counts, 9, q)
    # a value never lands above its bucket's inclusive upper edge
    for v in (1e-9, 3e-7, 0.001, 0.25, 0.5, 1.0, 7.0, 1e6):
        i = registry.bucket_index(v)
        assert v <= registry.bucket_upper_edge(i)
        if 0 < i < registry.HISTOGRAM_BUCKETS - 1:
            assert v > registry.bucket_upper_edge(i - 1)


def test_non_finite_values_clamped_not_poisoning():
    reg = registry.Registry()
    assert registry.bucket_index(math.inf) == registry.HISTOGRAM_BUCKETS - 1
    assert registry.bucket_index(math.nan) == 0
    reg.histo("h", 1.0)
    reg.histo("h", math.inf)
    reg.histo("h", math.nan)
    h = reg.snapshot()["histograms"]["h"]
    assert h["count"] == 3 and h["sum"] == 1.0 and math.isfinite(h["p50"])


def test_counter_rejects_negative():
    with pytest.raises(ValueError):
        registry.Registry().counter("c", -1)


def test_span_records_count_total_max_and_percentiles():
    reg = registry.Registry()
    for _ in range(3):
        with reg.span("s"):
            time.sleep(0.002)
    s = reg.snapshot()["spans"]["s"]
    assert s["count"] == 3
    assert s["total_seconds"] >= 0.003 and s["total_seconds"] >= s["max_seconds"]
    assert 0.0 < s["p50"] <= s["p99"]


def test_thread_safety_and_thread_local_nesting():
    reg = registry.Registry()

    def work(tid):
        for _ in range(200):
            reg.counter("n")
            with reg.span(f"t{tid}"):
                with reg.span("leaf"):
                    pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = reg.snapshot()
    assert snap["counters"]["n"] == 800
    for i in range(4):
        assert snap["spans"][f"t{i}"]["count"] == 200
        assert snap["spans"][f"t{i}/leaf"]["count"] == 200


def test_reset_and_delta_cursor_equal_jax():
    mine, theirs = registry.Registry(), jax_registry.Registry()
    cursors = []
    for reg in (mine, theirs):
        reg.counter("c")
        reg.histo("h", 0.5)
        d1, cur = reg.delta_since(None)
        reg.counter("c", 2)
        reg.gauge("g", 1)
        d2, cur = reg.delta_since(cur)
        reg.reset()
        d3, cur = reg.delta_since(cur)
        cursors.append((d1, d2, d3, cur.seq))
        assert reg.snapshot() == EMPTY
    assert cursors[0] == cursors[1]
    assert cursors[0][1]["counters"] == {"c": 2.0} and cursors[0][2]["full"] is True


def test_label_cardinality_cap_equals_jax():
    results = []
    for mod in (registry, jax_registry):
        prev = mod.set_label_cardinality_cap(3)
        try:
            reg = mod.Registry()
            for i in range(6):
                reg.counter("per_tenant", tenant=str(i))
                reg.gauge("g", i, tenant=str(i))
            reg.counter("plain")
            results.append(reg.snapshot())
        finally:
            mod.set_label_cardinality_cap(prev)
    assert results[0] == results[1]
    assert results[0]["counters"]["obs.labels.dropped{instrument=per_tenant}"] == 3
    with pytest.raises(ValueError):
        registry.set_label_cardinality_cap(0)


def test_module_level_gating():
    obs.counter("c")
    obs.gauge("g", 1)
    obs.histo("h", 1.0)
    with obs.span("s"):
        pass
    assert obs.snapshot() == EMPTY
    obs.enable()
    obs.counter("c", 2)
    obs.gauge("g", 7)
    with obs.span("s"):
        pass
    obs.disable()
    obs.counter("c")  # ignored
    snap = obs.snapshot()
    assert snap["counters"]["c"] == 2 and snap["gauges"]["g"] == 7
    assert snap["spans"]["s"]["count"] == 1


def test_port_and_jax_registries_are_separate():
    obs.enable()
    obs.counter("only.port")
    assert "only.port" not in jax_obs.snapshot()["counters"]
    assert obs.default_registry is not jax_registry.default_registry


# ------------------------------------------------------------- the timeline
def test_disabled_timeline_records_nothing():
    trace.instant("x", kind="test")
    trace.complete("y", time.perf_counter(), 0.001, kind="test")
    assert trace.events() == [] and trace.event_count() == 0


def test_instant_complete_and_span_mirror_equal_jax():
    got = []
    for o, t in ((obs, trace), (jax_obs, jax_trace)):
        o.enable()
        t.instant("i.name", kind="window", chunks=3)
        t.complete("c.name", time.perf_counter(), 0.25, kind="sync", lane="typed")
        with o.span("outer", tag="t"):
            time.sleep(0.001)
        with o.Registry().span("private"):
            pass  # a non-default registry never mirrors
        got.append([{k: v for k, v in e.items() if k not in ("ts", "tid")} | {"dur": e["dur"] > 0}
                    for e in t.events()])
    assert got[0] == got[1]
    assert [e["name"] for e in got[0]] == ["i.name", "c.name", "outer"]
    assert got[0][2]["labels"] == {"tag": "t"} and got[0][2]["kind"] == "span"


def test_ring_bounded_clear_and_capacity_equal_jax():
    seen = []
    for o, t in ((obs, trace), (jax_obs, jax_trace)):
        o.enable()
        t.set_capacity(4)
        for i in range(7):
            t.instant(f"e{i}", kind="test")
        names, dropped = [e["name"] for e in t.events()], t.dropped()
        events, total = t.events_since(5)
        t.set_capacity(2)
        shrunk = ([e["name"] for e in t.events()], t.dropped())
        t.clear()
        seen.append((names, dropped, [e["name"] for e in events], total, shrunk,
                     t.events(), t.dropped()))
        with pytest.raises(ValueError):
            t.set_capacity(0)
    assert seen[0] == seen[1]
    assert seen[0][0] == ["e3", "e4", "e5", "e6"] and seen[0][1] == 3


def _chrome(o, t, extra=None):
    o.enable()
    t.set_capacity(16)
    t.instant("moment", kind="window", chunks=2)
    with o.span("work"):
        time.sleep(0.001)
    t.instant("x", kind="test")
    return json.loads(o.chrome_trace(extra) if extra else o.chrome_trace())


def test_chrome_trace_keeps_the_jax_schema():
    extra = [{"name": "remote", "kind": "test", "ts": 1.0, "dur": 0.5,
              "labels": {"k": "v"}, "tid": 7, "rank": 3}]
    mine, theirs = _chrome(obs, trace, extra), _chrome(jax_obs, jax_trace, extra)
    assert set(mine) == set(theirs) and mine["displayTimeUnit"] == "ms"
    assert set(mine["otherData"]) == set(theirs["otherData"])
    assert len(mine["traceEvents"]) == len(theirs["traceEvents"])
    for a, b in zip(mine["traceEvents"], theirs["traceEvents"]):
        assert set(a) == set(b)
        assert (a["name"], a["cat"], a["ph"], a["args"]) == (b["name"], b["cat"], b["ph"], b["args"])
        for key in ("name", "cat"):
            assert isinstance(a[key], str)
        assert isinstance(a["pid"], int) and isinstance(a["tid"], int)
    by_name = {e["name"]: e for e in mine["traceEvents"]}
    assert by_name["moment"]["ph"] == "i" and by_name["moment"]["s"] == "t"
    assert by_name["work"]["ph"] == "X" and by_name["work"]["dur"] > 0
    assert by_name["remote"]["pid"] == 3 and by_name["moment"]["pid"] == 0


def test_chrome_trace_counts_dropped_events():
    obs.enable()
    trace.set_capacity(1)
    trace.instant("a", kind="test")
    trace.instant("b", kind="test")
    assert json.loads(obs.chrome_trace())["otherData"]["dropped_events"] == 1
