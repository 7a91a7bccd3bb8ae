"""The main path observed in both packages: the same instruments count the
same events.

A seeded stream of ``MulticlassAccuracy`` (with macro F1 beside it, so that
the class counts run) in a deferring ``MetricCollection`` and
``BinaryAUROC`` in another, and the same with ``BinaryAUROC(approx=True)``,
goes through both packages with obs enabled; both syncs then run in an
"echo world" of two ranks (the collective returns this rank's buffer
twice) in each package. The ``deferred.*``, ``sketch.*``, ``ops.*`` (label
values mapped through ``obs/inventory.py``) and ``toolkit.sync.*``
counters are equal, and so is the sequence of the window's timeline events
(``deferred.window.*``, ``deferred.window_step.dispatch``,
``deferred.fold.dispatch``). Where a count differs by design, the test says
why next to the name it leaves out. The fill/execute overlap histogram
(``deferred.window.overlap_ms``) records while the last window step's event
reports its work running (a stand-in event on the CPU).
"""

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
from torcheval_tpu import obs as jax_obs
from torcheval_tpu.metrics import toolkit as jtk
import torcheval_tpu_torch.metrics as T
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.metrics import toolkit as tk
from torcheval_tpu_torch.obs.inventory import jax_value
from torcheval_tpu_torch.utils.test_utils.obs_counts import parse_key

CPU = "cpu"
C, N, BATCHES, VALVE = 5, 96, 11, 4
PREFIXES = ("deferred.", "sketch.", "ops.", "toolkit.sync.")
# counted by the port and the JAX package alike, but not comparable:
# toolkit.sync.round_seconds holds wall time (its count is compared below);
# deferred.fold_calls is the port's own (obs/inventory.py's PORT_ONLY): the
# JAX package's fold is one XLA program whatever its shape
NOT_COMPARED = ("toolkit.sync.round_seconds", "deferred.fold_calls")


@pytest.fixture(autouse=True)
def _clean():
    for m in (obs, jax_obs):
        m.disable()
        m.reset()
    yield
    for m in (obs, jax_obs):
        m.disable()
        m.reset()


@pytest.fixture
def echo_worlds(monkeypatch):
    """A world of two in both packages in which the other rank holds this
    rank's states."""
    monkeypatch.setattr(tk._dist, "world_size", lambda group=None: 2)
    monkeypatch.setattr(tk._dist, "rank", lambda group=None: 0)
    monkeypatch.setattr(tk._dist, "all_gather_stacked", lambda x, pg: torch.stack([x, x]))
    monkeypatch.setattr(tk._dist, "collective_device", lambda pg: torch.device("cpu"))
    monkeypatch.setattr(jtk, "_world_size", lambda: 2)
    monkeypatch.setattr(jtk, "_process_index", lambda: 0)
    monkeypatch.setattr(jtk, "_allgather_stacked_impl", lambda x, group: np.stack([x, x]))


def _stream(seed=0):
    rng = np.random.default_rng(seed)
    return [
        (rng.random((N, C)).astype(np.float32), rng.integers(0, C, N),
         rng.random(N).astype(np.float32), (rng.random(N) < 0.3).astype(np.float32))
        for _ in range(BATCHES)
    ]


def _drive(mod, approx, stream, **kw):
    cls = mod.MetricCollection({
        "acc": mod.MulticlassAccuracy(num_classes=C, **kw),
        "f1": mod.MulticlassF1Score(num_classes=C, average="macro", **kw),
    })
    for m in cls.metrics.values():
        m._DEFER_MAX_CHUNKS = VALVE  # valve folds mid-stream, the same in both
    auroc = mod.BinaryAUROC(approx=True, **kw) if approx else mod.BinaryAUROC(
        compaction_threshold=3 * N, **kw)
    curve = mod.MetricCollection({"auroc": auroc})
    for scores, labels, x, t in stream:
        cls.update(scores, labels)
        curve.update(x, t)
    values = {**cls.compute(), **curve.compute()}
    module_tk = tk if mod is T else jtk
    synced = module_tk.sync_and_compute_collection(dict(cls.metrics), recipient_rank="all")
    synced_curve = module_tk.sync_and_compute_collection(dict(curve.metrics), recipient_rank="all")
    return values, {**synced, **synced_curve}


def _counters(module, port: bool):
    out = {}
    for key, v in module.snapshot()["counters"].items():
        name, labels = parse_key(key)
        if not name.startswith(PREFIXES) or name in NOT_COMPARED:
            continue
        if port:
            labels = {k: jax_value(name, k, val) for k, val in labels.items()}
        out[(name, tuple(sorted(labels.items())))] = v
    return out


def _window_events(module):
    # deferred.window_step.retire marks the JAX package's release of donated
    # inputs once their program retired; the port donates nothing
    # (metrics/deferred.py, "No donation"), so it has no such moment
    return [e["name"] for e in module.timeline_events()
            if e["name"].startswith(("deferred.window", "deferred.fold"))
            and e["name"] != "deferred.window_step.retire"]


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "approx"])
def test_main_path_counts_match(echo_worlds, approx):
    stream = _stream()
    obs.enable()
    jax_obs.enable()
    port_values, port_synced = _drive(T, approx, [tuple(map(torch.from_numpy, b)) for b in stream],
                                      device=CPU)
    jax_values, jax_synced = _drive(J, approx, stream)
    for k in jax_values:
        np.testing.assert_allclose(np.asarray(port_values[k], np.float64),
                                   np.asarray(jax_values[k], np.float64), rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(np.asarray(port_synced[k], np.float64),
                                   np.asarray(jax_synced[k], np.float64), rtol=1e-5, atol=1e-8)
    got, want = _counters(obs, True), _counters(jax_obs, False)
    assert got == want
    names = {name for name, _ in got}
    assert got[("toolkit.sync.rounds", ())] == 4  # two collections, two rounds each
    assert {"deferred.window_steps", "deferred.window_step_batches", "toolkit.sync.lane_bytes"} <= names
    assert ("sketch.folds" in names) == approx
    assert _window_events(obs) == _window_events(jax_obs)
    # the sync's latency histogram: one observation a round in both
    hist = {k: v["count"] for k, v in obs.snapshot()["histograms"].items()
            if k.startswith("toolkit.sync.round_seconds")}
    jhist = {k: v["count"] for k, v in jax_obs.snapshot()["histograms"].items()
             if k.startswith("toolkit.sync.round_seconds")}
    assert hist == jhist and sum(hist.values()) == 4


class _FakeEvent:
    """A window step's event whose work runs for ``busy`` queries."""

    def __init__(self, busy):
        self.busy = busy

    def query(self):
        self.busy -= 1
        return self.busy < 0


@pytest.mark.parametrize("busy,recorded", [(0, False), (3, True), (100, True)])
def test_window_overlap_is_recorded_while_the_last_step_runs(monkeypatch, busy, recorded):
    from torcheval_tpu_torch.metrics import deferred

    obs.enable()
    col = T.MetricCollection({"sum": T.Sum(device=CPU)})
    x = torch.ones(8)
    col.update(x)
    col.update(x)  # armed
    col.compute()
    monkeypatch.setattr(deferred, "_last_window_event", _FakeEvent(busy))
    for _ in range(5):
        col.update(x)
    col.compute()
    h = obs.snapshot()["histograms"].get("deferred.window.overlap_ms")
    assert (h is not None and h["count"] == 1 and h["sum"] > 0.0) == recorded
