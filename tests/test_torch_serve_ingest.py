"""The port's ingest pipeline and deferred-ack pipelining on the CPU.

Counterparts: ``tests/serve/test_ingest.py`` and ``tests/serve/test_pipeline.py``.
Beyond the JAX cases:

* ``coalesce_h2d`` packs a group's unique arrays at 256-byte offsets of
  one buffer and returns dtype views into it; every dtype the staging
  pass admits (bool, signed and unsigned ints, halves, floats, complex,
  zero-size, 0-d, non-contiguous, byte-swapped) comes back equal to the
  JAX package's ``coalesce_h2d`` on the same arrays;
* the aliasing contract: a batch that lands in a pooled slot, is staged,
  released and then OVERWRITTEN before the window folds, still computes
  the value of the bytes it was submitted with (coalesced, per-batch and
  sliced tenants);
* an anchor whose probe raises propagates the error and never frees the
  slot (the JAX package treats a raising probe as retired: donation);
* ``MetricCollection.update_placed``: ``owned=True`` equals ``update``,
  appends the given tensors without a copy, and refuses another device;
* a sliced tenant's id column is never staged to the device.
"""

import io
import os
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

import torcheval_tpu.serve.ingest as jingest
import torcheval_tpu_torch.metrics as tm
import torcheval_tpu_torch.serve as ts
from torcheval_tpu_torch import obs as tobs
from torcheval_tpu_torch.metrics import deferred as tdeferred
from torcheval_tpu_torch.obs import registry as treg
from torcheval_tpu_torch.obs import trace as ttrace
from torcheval_tpu_torch.resilience import chaos as tchaos
from torcheval_tpu_torch.serve.client import _ClientTenant, _PipelinedChannel
from torcheval_tpu_torch.serve.errors import WireError
from torcheval_tpu_torch.serve.ingest import HostBufferPool, SharedStage, coalesce_h2d, group_anchor
from torcheval_tpu_torch.serve.wire import pack_tree, pack_tree_parts, recv_frame, send_frame_parts, unpack_tree

C = 5
SPEC = {"acc": ts.metric_spec("MulticlassAccuracy", num_classes=C)}


def _batch(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return rng.random((n, C)).astype(np.float32), rng.integers(0, C, n)


def _tacc():
    return tm.MulticlassAccuracy(num_classes=C, device="cpu")


def _oracle(batches):
    m = _tacc()
    for s, l in batches:
        m.update(s, l)
    return np.asarray(m.compute()).tobytes()


def _pool(**kw):
    return HostBufferPool(device="cpu", **kw)


@pytest.fixture
def obs_on():
    tobs.reset()
    tobs.enable()
    yield
    tobs.disable()
    tobs.reset()


class _FakeAnchor:
    def __init__(self, ready=False):
        self.ready = ready

    def is_ready(self):
        return self.ready


# ----------------------------------------------------- zero-copy decode
def _payload(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    scores, labels = rng.random((n, C)).astype(np.float32), rng.integers(0, C, n)
    spec, blob = pack_tree([scores, labels])
    return spec, blob, scores, labels


def test_steady_decode_leaves_are_views_over_the_payload():
    spec, blob, scores, labels = _payload()
    out = unpack_tree(spec, blob)
    np.testing.assert_array_equal(out[0], scores)
    np.testing.assert_array_equal(out[1], labels)
    payload = np.frombuffer(blob, dtype=np.uint8)
    assert all(not leaf.flags.owndata and np.shares_memory(leaf, payload) for leaf in out)
    backing = payload.copy()
    out = unpack_tree(spec, memoryview(backing))
    assert np.shares_memory(out[0], backing)


def test_steady_decode_performs_no_per_leaf_allocation():
    spec, blob, *_ = _payload(n=8192)
    for _ in range(3):
        unpack_tree(spec, blob)
    tracemalloc.start()
    try:
        snap0 = tracemalloc.take_snapshot()
        keep = [unpack_tree(spec, blob) for _ in range(20)]
        snap1 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = sum(d.size_diff for d in snap1.compare_to(snap0, "filename") if d.size_diff > 0)
    assert keep and grown / 20 < 8192


def test_decode_fallbacks_and_rejections():
    arr = np.arange(100, dtype=np.float64)
    buf = io.BytesIO()
    np.savez_compressed(buf, a0=arr)
    out = unpack_tree({"t": "arr", "i": "a0"}, buf.getvalue())
    np.testing.assert_array_equal(out, arr)
    assert out.flags.owndata
    buf = io.BytesIO()
    np.savez(buf, a0=np.array([{"pickle": "bomb"}], dtype=object))
    for spec, blob in (({"t": "arr", "i": "a0"}, buf.getvalue()), ({"t": "arr", "i": "a0"}, b"not npz !!")):
        with pytest.raises(WireError):
            unpack_tree(spec, blob)
    fortran = np.asfortranarray(np.arange(12, dtype=np.int32).reshape(3, 4))
    np.testing.assert_array_equal(unpack_tree(*pack_tree([fortran]))[0], fortran)


def test_frame_with_more_parts_than_iov_max_round_trips():
    import socket

    tree = [np.full((3,), i, dtype=np.int32) for i in range(600)]
    spec, parts, total = pack_tree_parts(tree)
    assert len(parts) > 1024
    a, b = socket.socketpair()
    try:
        box = {}
        t = threading.Thread(target=lambda: box.update(frame=recv_frame(b)))
        t.start()
        send_frame_parts(a, {"op": "x"}, parts, total)
        t.join(10.0)
        got = unpack_tree(spec, box["frame"][1])
        assert [int(g[0]) for g in got] == list(range(600))
    finally:
        a.close()
        b.close()


# ------------------------------------------------------- the buffer pool
def test_pool_hit_miss_grow_counters(obs_on):
    pool = _pool()
    a = pool.acquire(1000)
    a.release()
    b = pool.acquire(1000)
    b.release(anchor=_FakeAnchor(ready=False))
    c = pool.acquire(1000)
    counters = treg.snapshot()["counters"]
    for result in ("miss", "hit", "grow"):
        assert counters.get(f"serve.ingest.pool{{result={result}}}") == 1.0
    assert b is not c


def test_inflight_buffer_not_recycled_until_anchor_retires():
    pool = _pool()
    buf = pool.acquire(2048)
    view = buf.view(16)
    view[:] = b"A" * 16
    anchor = _FakeAnchor(ready=False)
    buf.release(anchor=anchor)
    fresh = pool.acquire(2048)
    assert fresh is not buf and bytes(view) == b"A" * 16
    assert pool.stats()["cooling"] == 1
    anchor.ready = True
    fresh.release()
    again = pool.acquire(2048)
    assert pool.stats()["cooling"] == 0
    again.release()


def test_shared_stage_frees_only_when_all_anchors_retire():
    pool = _pool()
    buf = pool.acquire(1024)
    shared = SharedStage(buf, 3)
    slow, fast = _FakeAnchor(ready=False), _FakeAnchor(ready=True)
    shared.release(anchor=slow)
    shared.release(anchor=fast)
    buf.release()  # a direct release is a no-op while split
    assert not buf.released
    shared.release()
    assert buf.released
    other = pool.acquire(1024)
    assert other is not buf and pool.stats()["cooling"] == 1
    slow.ready = True
    other.release()
    assert pool.acquire(1024) is buf


def test_release_idempotent_shrink_and_size_classes():
    pool = _pool(idle_ttl_s=0.01)
    buf = pool.acquire(100)
    buf.release()
    buf.release()
    assert pool.stats()["free"] == 1
    bufs = [pool.acquire(4096) for _ in range(3)]
    for b in bufs:
        b.release()
    time.sleep(0.03)
    pool.shrink()
    assert pool.stats()["free"] == 0
    buf = pool.acquire(5000)
    assert buf.nbytes == 8192
    buf.release()
    assert pool.acquire(8000) is buf


def test_a_cpu_pool_is_plain_memory_and_the_default_pool_is_cuda():
    buf = _pool().acquire(64)
    assert not buf.tensor.is_pinned()
    assert np.shares_memory(buf.data, buf.tensor.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            HostBufferPool()


def test_a_raising_anchor_probe_propagates_and_keeps_the_slot():
    class Broken:
        def is_ready(self):
            raise RuntimeError("device lost")

    pool = _pool()
    buf = pool.acquire(512)
    buf.release(anchor=_FakeAnchor(ready=False))
    pool._cooling[0] = (buf, group_anchor([Broken()]))
    with pytest.raises(RuntimeError, match="device lost"):
        pool.acquire(512)
    assert pool.stats()["cooling"] == 1 and pool.stats()["free"] == 0


# ----------------------------------------------------- coalesced copies
def test_one_transfer_per_group_and_ownership(obs_on):
    rng = np.random.default_rng(2)
    shared = rng.random((8, 3)).astype(np.float32)
    distinct_a, distinct_b = rng.integers(0, 3, 8), rng.integers(0, 3, 8)
    ttrace.clear()
    placed, owned, anchor = coalesce_h2d([(shared, distinct_a), (shared, distinct_b)], "cpu")
    transfers = [e for e in ttrace.events() if e["name"] == "serve.ingest.transfer"]
    assert len(transfers) == 1 and transfers[0]["labels"]["arrays"] == 3
    assert treg.snapshot()["counters"]["serve.ingest.h2d_bytes"] == float(
        shared.nbytes + distinct_a.nbytes + distinct_b.nbytes
    )
    assert placed[0][0] is placed[1][0] and placed[0][1] is not placed[1][1]
    assert owned == [False, False] and anchor is None
    np.testing.assert_array_equal(placed[0][0].numpy(), shared)
    np.testing.assert_array_equal(placed[1][1].numpy(), distinct_b)


def _dtype_cases():
    rng = np.random.default_rng(3)
    wide = rng.integers(0, 100, (6, 7)).astype(np.int64)
    return [
        rng.random((4, 2)).astype(np.float32),
        rng.integers(0, 2, 4),
        rng.random(5) < 0.5,
        rng.integers(-100, 100, 7).astype(np.int8),
        rng.integers(0, 60000, 3).astype(np.uint16),
        rng.random(9).astype(np.float16),
        rng.random(3),
        (rng.random(4) + 1j * rng.random(4)).astype(np.complex64),
        np.zeros((0, 5), np.float32),
        np.float32(2.5).reshape(()),
        wide[:, ::2],  # non-contiguous
        np.arange(6, dtype=">i4"),  # byte-swapped
    ]


def test_packed_views_equal_the_jax_transfer_for_every_staged_dtype():
    arrays = _dtype_cases()
    batches = [tuple(arrays[:6]), tuple(arrays[6:])]
    placed, owned, _ = coalesce_h2d(batches, "cpu")
    # JAX takes native byte order only
    native = [tuple(a.astype(a.dtype.newbyteorder("=")) for a in b) for b in batches]
    jplaced, jowned = jingest.coalesce_h2d(native)
    assert owned == jowned == [True, True]
    base = placed[0][0].untyped_storage().data_ptr()
    for mine, theirs, host in zip(
        [t for b in placed for t in b], [t for b in jplaced for t in b], arrays
    ):
        got = mine.numpy()
        assert got.shape == host.shape and got.dtype == host.dtype.newbyteorder("=")
        np.testing.assert_array_equal(got, host)
        theirs = np.asarray(theirs)
        if theirs.dtype == got.dtype:  # JAX narrows 64-bit types without x64
            np.testing.assert_array_equal(got, theirs)
        assert mine.untyped_storage().data_ptr() == base  # one buffer
        assert (mine.data_ptr() - base) % 256 == 0 or mine.numel() == 0


def test_exclusive_batches_stay_owned():
    batches = [_batch(seed=i, n=4) for i in range(3)]
    placed, owned, _ = coalesce_h2d(batches, "cpu")
    assert owned == [True, True, True]
    for (hs, hl), (ds, dl) in zip(batches, placed):
        np.testing.assert_array_equal(ds.numpy(), hs)
        np.testing.assert_array_equal(dl.numpy(), hl)


# --------------------------------------------------- the aliasing contract
@pytest.mark.parametrize("kind", ["coalesced", "per_batch", "sliced"])
def test_an_overwritten_slot_never_reaches_the_fold(kind):
    """Submit through the wire (the payload lands in a pooled slot), let
    the worker stage and release the slot, overwrite every free slot of
    the pool with garbage, and only then fold (compute): the value is the
    one the submitted bytes give."""
    rng = np.random.default_rng(11)
    batches = [_batch(seed=30 + i, n=64) for i in range(3)]
    ids = [rng.integers(0, 4, 64) for _ in batches]
    with ts.EvalDaemon(device="cpu") as daemon:
        server = ts.EvalServer(daemon)
        client = ts.EvalClient(server.endpoint, local_transport=False)
        try:
            if kind == "sliced":
                client.attach("t", {"acc": ["BinaryAccuracy", {}]}, slices=True)
                for (s, _l), i in zip(batches, ids):
                    client.submit("t", i, s[:, 0], (s[:, 1] > 0.5).astype(np.float32))
            else:
                client.attach("t", SPEC, nan_policy="reject" if kind == "per_batch" else "propagate")
                for s, l in batches:
                    client.submit("t", s, l)
            deadline = time.monotonic() + 30
            while daemon.health()["tenants"]["t"]["processed"] < len(batches):
                assert time.monotonic() < deadline
                time.sleep(0.01)
            pool = server._pool
            pool.shrink(now=0.0)  # sweep the cooling rack, keep the free slots
            with pool._lock:
                slots = [b for free in pool._free.values() for b, _t in free]
            assert slots, "no released slot to overwrite"
            for b in slots:
                b.data[:] = 0xFF
            got = client.compute("t")
        finally:
            client.close()
            server.close()
    if kind == "sliced":
        col = tm.SlicedMetricCollection({"acc": tm.BinaryAccuracy(device="cpu")})
        for (s, _l), i in zip(batches, ids):
            col.update(i, s[:, 0], (s[:, 1] > 0.5).astype(np.float32))
        want = col.compute()
        assert np.asarray(got["acc"]["values"]).tobytes() == np.asarray(want["acc"]["values"]).tobytes()
    else:
        assert np.asarray(got["acc"]).tobytes() == _oracle(batches)


# ------------------------------------------------------------ update_placed
def test_update_placed_owned_equals_update_and_does_not_copy():
    batches = [_batch(seed=40 + i, n=32) for i in range(4)]
    ref = tm.MetricCollection({"acc": _tacc(), "f1": tm.MulticlassF1Score(num_classes=C, device="cpu")})
    col = tm.MetricCollection({"acc": _tacc(), "f1": tm.MulticlassF1Score(num_classes=C, device="cpu")})
    for s, l in batches:
        ref.update(s, l)
        placed = (torch.from_numpy(s.copy()), torch.from_numpy(l.copy()))
        col.update_placed(placed, owned=True)
        head = col._window.chunks[-1] if col._window.chunks else None
        if head is not None:
            assert all(x is y for x, y in zip(head, placed))
    assert col._window.owned
    want, got = ref.compute(), col.compute()
    for k in want:
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes()


def test_update_placed_refuses_another_device():
    col = tm.MetricCollection({"acc": _tacc()})
    with pytest.raises(ValueError, match="update_placed"):
        col.update_placed((torch.zeros(4, C, device="meta"), torch.zeros(4, dtype=torch.long)))


def test_a_sliced_tenants_id_column_is_never_staged(obs_on):
    with ts.EvalDaemon(device="cpu") as daemon:
        staged = []
        orig = daemon._coalesce
        daemon._coalesce = lambda batches, device: staged.append(batches) or orig(batches, device)
        h = daemon.attach("s", {"acc": tm.BinaryAccuracy(device="cpu")}, slices=True)
        rng = np.random.default_rng(5)
        for _ in range(3):
            h.submit(rng.integers(0, 9, 50), rng.random(50).astype(np.float32), (rng.random(50) < 0.5).astype(np.float32))
        h.compute()
    assert staged == []
    assert "serve.ingest.h2d_bytes" not in treg.snapshot()["counters"]
    assert tm.SlicedMetricCollection._host_ingest_only is True


# ---------------------------------------------------- daemon-side ingest
def _pair(test_kw=None, **client_kw):
    daemon = ts.EvalDaemon(device="cpu", **(test_kw or {})).start()
    server = ts.EvalServer(daemon)
    client_kw.setdefault("local_transport", False)
    client = ts.EvalClient(server.endpoint, **client_kw)
    return daemon, server, client


def _close_pair(daemon, server, client):
    client.close()
    server.close()
    daemon.stop()


def test_failed_coalesced_drain_redelivers_before_compute():
    batches = [_batch(seed=70 + i, n=16) for i in range(6)]
    daemon, server, client = _pair(submit_buffer=3, max_attempts=1, local_transport=True)
    try:
        client.attach("t", SPEC)
        client.submit("t", *batches[0])
        client.submit("t", *batches[1])
        orig, tripped = client._call, []

        def flaky(op, *a, **k):
            if op == "submit_many" and not tripped:
                tripped.append(op)
                raise WireError("transport", "injected", endpoint=client.endpoint)
            return orig(op, *a, **k)

        client._call = flaky
        with pytest.raises(WireError) as ctx:
            client.submit("t", *batches[2])
        assert getattr(ctx.value, "batch_booked", False)
        client._call = orig
        for s, l in batches[3:]:
            client.submit("t", s, l)
        got = client.compute("t")
    finally:
        _close_pair(daemon, server, client)
    assert np.asarray(got["acc"]).tobytes() == _oracle(batches)


def test_quarantine_releases_staged_buffers():
    scores, labels = _batch(seed=4, n=16)
    daemon, server, client = _pair(max_attempts=1)
    try:
        client.attach("t", SPEC)
        assert client.submit("t", scores, labels)
        try:
            client.submit("t", scores[:4], labels[:3])
        except ts.TenantQuarantinedError:
            pass
        quarantined, deadline = False, time.monotonic() + 10.0
        while time.monotonic() < deadline and not quarantined:
            try:
                client.submit("t", scores, labels)
            except ts.TenantQuarantinedError:
                quarantined = True
            else:
                time.sleep(0.02)
        assert quarantined
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            server._pool.shrink(now=time.monotonic() - 1e6)
            stats = server._pool.stats()
            if stats["cooling"] == 0:
                break
            time.sleep(0.05)
        assert stats["cooling"] == 0, stats
    finally:
        _close_pair(daemon, server, client)


def test_wire_and_local_results_bit_identical_and_window_knob():
    batches = [_batch(seed=50 + i, n=32) for i in range(6)]
    daemon, server, client = _pair(local_transport=True)
    try:
        client.attach("wire", SPEC)
        local = daemon.attach("local", {"acc": _tacc()}, window_chunks=4)
        assert daemon._tenants["local"].collection._defer_probe._DEFER_MAX_CHUNKS == 4
        for s, l in batches:
            client.submit("wire", s, l)
            local.submit(s, l, block=True, timeout=60)
        assert np.asarray(client.compute("wire")["acc"]).tobytes() == np.asarray(
            local.compute(timeout=60)["acc"]
        ).tobytes()
        with pytest.raises(ValueError):
            daemon.attach("t2", {"acc": _tacc()}, window_chunks=0)
    finally:
        _close_pair(daemon, server, client)


def test_overlap_recorded_while_previous_step_in_flight(obs_on):
    class Running:
        def query(self):
            return False

    col = tm.MetricCollection({"acc": _tacc()})
    prev = tdeferred._last_window_event
    tdeferred._last_window_event = Running()
    try:
        for i in range(3):
            col.update(*_batch(seed=60 + i))
        col.compute()
    finally:
        tdeferred._last_window_event = prev
    assert treg.snapshot()["histograms"]["deferred.window.overlap_ms"]["count"] > 0


# ---------------------------------------------------------- pipelining
def _pipe_oracle(n):
    return _oracle([_batch(seed=i) for i in range(n)])


def _acc_bytes(client, tenant):
    return np.asarray(client.compute(tenant)["acc"]).tobytes()


def test_pipeline_negotiation():
    daemon = ts.EvalDaemon(device="cpu").start()
    servers = {d: ts.EvalServer(daemon, pipeline_depth=d) for d in (4, 0)}
    try:
        client = ts.EvalClient(servers[4].endpoint, pipeline_depth=8, local_transport=False)
        client.attach("t", SPEC)
        assert client._pipeline_granted == 4
        assert client.submit("t", *_batch())
        assert client._channel is not None and client._channel.depth == 4
        client.close()
        for stale in (False, True):
            client = ts.EvalClient(servers[0].endpoint, pipeline_depth=8, local_transport=False)
            client.attach(f"old{stale}", SPEC)
            assert client._pipeline_granted == 0
            if stale:
                client._pipeline_granted = 8  # a stale grant: pipeline_open is rejected
            for i in range(3):
                assert client.submit(f"old{stale}", *_batch(seed=i))
            assert client._channel is None
            assert client._pipeline_unsupported is stale
            assert _acc_bytes(client, f"old{stale}") == _pipe_oracle(3)
            client.close()
        for bad in (0, -1, 1.5, "4"):
            with pytest.raises(ValueError):
                ts.EvalClient("127.0.0.1:1", pipeline_depth=bad)
        with pytest.raises(ValueError):
            ts.EvalServer(daemon, pipeline_depth=-1)
    finally:
        for s in servers.values():
            s.close()
        daemon.stop()


def test_stream_matches_oracle_with_deferred_acks(obs_on):
    daemon, server, client = _pair(pipeline_depth=8)
    try:
        client.attach("t", SPEC)
        for i in range(20):
            assert client.submit("t", *_batch(seed=i))
        assert _acc_bytes(client, "t") == _pipe_oracle(20)
        health = client.health()["tenants"]["t"]
        assert (health["processed"], health["dupes"]) == (20, 0)
        snap = tobs.snapshot()
        assert snap["counters"].get("serve.wire.acks_deferred", 0) >= 20
        assert any(k.startswith("serve.client.inflight{") for k in snap["histograms"])
    finally:
        _close_pair(daemon, server, client)


def test_out_of_order_acks_fold_through_the_watermark():
    state = _ClientTenant(0)
    for seq in range(1, 8):
        state.replay.append((seq, ("b%d" % seq,)))
    acks = [{"ok": True, "acked_seq": s} for s in (5, 2, 7, 3)]
    _PipelinedChannel._fold_acks(state, acks, dirty=False)
    assert state.durable_seq == 7 and list(state.replay) == [] and not state.needs_resend
    state2 = _ClientTenant(0)
    state2.replay.append((1, ("b1",)))
    _PipelinedChannel._fold_acks(state2, [{"ok": False, "error": {"reason": "queue_full"}}], dirty=False)
    assert state2.needs_resend
    state3 = _ClientTenant(0)
    _PipelinedChannel._fold_acks(state3, [], dirty=True)
    assert state3.needs_resend


def test_full_replay_buffer_flushes_mid_pipeline(tmp_path):
    daemon, server, client = _pair({"evict_dir": str(tmp_path)}, pipeline_depth=4, replay_capacity=4)
    try:
        client.attach("t", SPEC)
        for i in range(12):
            assert client.submit("t", *_batch(seed=i))
        state = client._tenant_state("t")
        assert state.durable_seq > 0 and len(state.replay) <= 4
        assert _acc_bytes(client, "t") == _pipe_oracle(12)
        assert client.health()["tenants"]["t"]["dupes"] == 0
    finally:
        _close_pair(daemon, server, client)


def test_migration_replays_deep_unacked_tail():
    a = _pair(pipeline_depth=8)
    b = _pair(pipeline_depth=8)
    try:
        a[2].attach("t", SPEC)
        for i in range(10):
            assert a[2].submit("t", *_batch(seed=i))
        exported = a[2].export_tenant("t")
        assert exported["durable_seq"] == 0 and len(exported["replay"]) == 10
        attach_b = b[2].attach("t", SPEC)
        assert b[2].adopt_tenant("t", exported, restored_seq=attach_b["last_seq"]) == 10
        assert _acc_bytes(b[2], "t") == _pipe_oracle(10)
        assert b[2].health()["tenants"]["t"]["dupes"] == 0
    finally:
        _close_pair(*a)
        _close_pair(*b)


def test_gapless_admission_refuses_seq_past_a_hole():
    with ts.EvalDaemon(device="cpu") as daemon:
        handle = daemon.attach("t", _tacc())
        scores, labels = _batch()
        assert handle.submit(scores, labels, seq=1, gapless=True)
        with pytest.raises(ts.BackpressureError) as ctx:
            handle.submit(scores, labels, seq=3, gapless=True)
        assert ctx.value.reason == "seq_gap" and ctx.value.retryable
        assert handle.submit(scores, labels, seq=2, gapless=True)
        assert handle.submit(scores, labels, seq=3, gapless=True)
        assert handle.submit(scores, labels, seq=9)


def test_channel_death_falls_back_and_resends():
    daemon, server, client = _pair(pipeline_depth=8)
    try:
        client.attach("t", SPEC)
        for i in range(5):
            assert client.submit("t", *_batch(seed=i))
        assert client._channel is not None
        client._channel._fail(WireError("transport", "test-severed"))
        for i in range(5, 8):
            assert client.submit("t", *_batch(seed=i))
        assert _acc_bytes(client, "t") == _pipe_oracle(8)
        assert client.health()["tenants"]["t"]["processed"] == 8
    finally:
        _close_pair(daemon, server, client)


@pytest.mark.parametrize("action,extra", [("ack_delay", {"TORCHEVAL_TPU_CHAOS_DELAY_S": "0.3"}), ("ack_reorder", {})])
def test_stream_survives_an_ack_fault_bit_identically(monkeypatch, action, extra):
    env = {
        "TORCHEVAL_TPU_CHAOS": "1",
        "TORCHEVAL_TPU_CHAOS_ACTION": action,
        "TORCHEVAL_TPU_CHAOS_TENANT": "*",
        "TORCHEVAL_TPU_CHAOS_STEP": "2",
        **extra,
    }
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tchaos.reset_for_tests()
    try:
        daemon, server, client = _pair(pipeline_depth=4)
        try:
            client.attach("t", SPEC)
            for i in range(8):
                assert client.submit("t", *_batch(seed=i))
            assert _acc_bytes(client, "t") == _pipe_oracle(8)
            health = client.health()["tenants"]["t"]
            assert (health["processed"], health["dupes"]) == (8, 0)
            assert tchaos._ack_fired, "chaos ack action never fired"
        finally:
            _close_pair(daemon, server, client)
    finally:
        for k in env:
            monkeypatch.delenv(k)
        tchaos.reset_for_tests()


def test_many_producers_one_channel():
    daemon, server, client = _pair(pipeline_depth=8)
    try:
        tenants = [f"t{i}" for i in range(3)]
        for t in tenants:
            client.attach(t, SPEC)
        errors = []

        def producer(t):
            try:
                for i in range(10):
                    client.submit(t, *_batch(seed=i))
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(e)

        threads = [threading.Thread(target=producer, args=(t,)) for t in tenants]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert errors == []
        for t in tenants:
            assert _acc_bytes(client, t) == _pipe_oracle(10)
            assert client.health()["tenants"][t]["dupes"] == 0
    finally:
        _close_pair(daemon, server, client)


def test_the_ingest_module_imports_no_jax():
    import torcheval_tpu_torch.serve.ingest as mod

    src = open(mod.__file__).read()
    assert "import jax" not in src and "torcheval_tpu." not in src
    assert os.path.basename(mod.__file__) == "ingest.py"
