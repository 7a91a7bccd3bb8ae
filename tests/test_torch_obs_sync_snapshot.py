"""``torcheval_tpu_torch/obs/distributed.py`` (``sync_snapshot``) and
``obs/httpd.py`` against the JAX package's.

``_merge`` gives the JAX package's cluster view on the same payloads; each
package decodes the other's ``_encode`` buffer (the buffers are the same
bytes), its staged fallback included. A 2-rank gloo world
(``utils/test_utils/obs_worker.py``) runs one round: exactly one more
``toolkit.sync.rounds`` per rank, merged counters equal to the sum of the
ranks' local snapshots, rank-labelled gauges, and rank 0's ``MetricsServer``
answering ``GET /metrics`` with ``prometheus_text()``'s bytes. A world whose
peer left degrades to the local view under ``on_failure="local"``. The cases
mirror ``tests/obs/test_sync_snapshot.py``, ``test_sync_snapshot_mp.py`` and
``test_httpd.py``.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from torcheval_tpu import obs as jax_obs
from torcheval_tpu.obs import distributed as jax_distributed
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.obs import distributed
from torcheval_tpu_torch.utils.test_utils import obs_worker

WORLD = 2


def _payload(rank, events=2):
    b = [0] * 64
    b[30 + rank] = 2
    return {
        "rank": rank,
        "counters": [("toolkit.sync.rounds", (), 2.0 + rank),
                     ("deferred.folds", (("entry", "fold"), ("path", "stacked")), 1.0)],
        "gauges": [("toolkit.sync.world_size", (), 2.0)],
        "histos": [("toolkit.sync.round_seconds", (("lane", "typed"),), (tuple(b), 2, 0.5 + rank))],
        "spans": [("collection.update", (), (3, 0.1 * (rank + 1), 0.05, tuple(b)))],
        "events": [{"ts": float(i), "dur": 0.0, "name": f"e{i}", "kind": "instant", "labels": {},
                    "tid": 1} for i in range(events)],
        "truncated": False,
    }


@pytest.fixture(autouse=True)
def _clean():
    for m in (obs, jax_obs):
        m.disable()
        m.reset()
    yield
    for m in (obs, jax_obs):
        m.disable()
        m.reset()


@pytest.mark.parametrize("ranks", [(0,), (0, 1), (1, 0, 2)])
def test_merge_matches_the_jax_merge(ranks):
    payloads = [_payload(r) for r in ranks]
    for degraded in (False, True):
        got = distributed._merge(payloads, len(ranks), degraded=degraded)
        want = jax_distributed._merge(payloads, len(ranks), degraded=degraded)
        assert got == want


@pytest.mark.parametrize("max_bytes", [1 << 20, 1200, 700, 16])
def test_each_package_decodes_the_others_buffer(max_bytes):
    payload = _payload(1, events=20)
    port = distributed._encode(payload, max_bytes)
    ref = jax_distributed._encode(payload, max_bytes)
    assert port.dtype == np.uint8 and port.shape == (max_bytes,)
    np.testing.assert_array_equal(port, ref)  # the same staged fallback, byte for byte
    assert distributed._decode(ref) == jax_distributed._decode(port)


def test_world_of_one_is_the_local_view_without_a_round():
    obs.enable()
    obs.counter("toolkit.sync.rounds", 3)
    view = obs.sync_snapshot()
    assert view["world_size"] == 1 and view["counters"]["toolkit.sync.rounds"] == 3.0
    assert obs.snapshot()["counters"]["toolkit.sync.rounds"] == 3.0  # no round ran
    assert "obs.sync_snapshot{world=1}" in obs.snapshot()["spans"]
    with pytest.raises(ValueError):
        obs.sync_snapshot(max_bytes=8)
    with pytest.raises(ValueError):
        obs.sync_snapshot(on_failure="ignore")


def test_a_two_rank_world_merges_in_one_round(tmp_path):
    rcs, outs, results = obs_worker.launch("snapshot", str(tmp_path), WORLD, timeout_s=120)
    assert rcs == [0] * WORLD, outs
    summed = {}
    for res in results:
        for k, v in res["local"]["counters"].items():
            summed[k] = summed.get(k, 0.0) + v
    for r, res in enumerate(results):
        merged = res["merged"]
        assert res["synced"] == 3.0
        assert res["extra_rounds"] == 1
        assert res["buffer_bytes"] == distributed.DEFAULT_MAX_BYTES
        assert merged["world_size"] == WORLD and merged["ranks"] == [0, 1]
        assert not merged["degraded"] and merged["truncated_ranks"] == []
        assert merged["counters"] == summed
        assert merged["gauges"]["dist_curves.world_size{rank=0}"] == 2.0
        assert merged["gauges"]["dist_curves.world_size{rank=1}"] == 3.0
        assert all("rank=" in g for g in merged["gauges"])
        h = merged["histograms"]["toolkit.sync.round_seconds{lane=typed}"]
        assert h["count"] == sum(
            x["local"]["histograms"]["toolkit.sync.round_seconds{lane=typed}"]["count"] for x in results)
        assert {e["rank"] for e in merged["events"]} == {0, 1}
    assert results[0]["metrics_equal"] and results[0]["health"] == {"ok": True}


def test_a_departed_peer_degrades_to_the_local_view(tmp_path):
    rcs, outs, results = obs_worker.launch("dead", str(tmp_path), WORLD, timeout_s=120)
    assert rcs[0] == 0, outs
    res = results[0]
    assert res["merged"]["degraded"] and res["merged"]["world_size"] == 1
    assert res["merged"]["counters"]["deferred.folds{entry=fold,path=stacked}"] == 1.0
    assert res["timeouts"] == 1.0 and res["seconds"] < 60


def test_metrics_server_routes():
    obs.enable()
    obs.counter("toolkit.sync.rounds", 2)
    srv = obs.MetricsServer(port=0, health_provider=lambda: {"ok": True, "load": 0.5}).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert r.read() == obs.prometheus_text().encode()
            assert r.headers["Content-Type"].startswith("text/plain; version=0.0.4")
        with urllib.request.urlopen(base + "/health", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True, "load": 0.5}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert srv.address == ("127.0.0.1", srv.port)
    finally:
        srv.close()
        srv.close()  # idempotent
