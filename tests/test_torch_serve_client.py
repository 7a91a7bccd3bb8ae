"""The port's ``EvalClient`` on the CPU: deadlines, retries, the circuit
breaker, bounded in-flight, exactly-once bookkeeping, the same-process
local transport and the obs push channel.

Counterparts: ``tests/serve/test_client.py``,
``tests/serve/test_local_transport.py`` and the single-host half of
``tests/serve/test_obs_stream.py`` (its fleet half needs the router,
which is not ported). Every socket binds port 0.
"""

import socket
import threading
import time
import tracemalloc

import numpy as np
import pytest

import torcheval_tpu_torch.metrics as tm
import torcheval_tpu_torch.serve as ts
from torcheval_tpu_torch import obs as tobs
from torcheval_tpu_torch.obs.stream import DeltaAccumulator
from torcheval_tpu_torch.serve import wire as twire
from torcheval_tpu_torch.serve.client import _ClientTenant
from torcheval_tpu_torch.serve.ingest import SharedStage
from torcheval_tpu_torch.serve.wire import local_server, pack_tree, recv_frame, send_frame

C = 5
SPEC = {"acc": ts.metric_spec("MulticlassAccuracy", num_classes=C)}


def _batch(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return rng.random((n, C)).astype(np.float32), rng.integers(0, C, n)


def _oracle(batches):
    m = tm.MulticlassAccuracy(num_classes=C, device="cpu")
    for s, l in batches:
        m.update(s, l)
    return np.asarray(m.compute()).tobytes()


def _acc(client, tenant):
    return np.asarray(client.compute(tenant)["acc"]).tobytes()


@pytest.fixture
def obs_on():
    tobs.reset()
    tobs.enable()
    yield
    tobs.disable()
    tobs.reset()


@pytest.fixture
def stack():
    """``make(server_cls=, **client_kw) -> (daemon, server, client)``,
    everything closed at teardown."""
    made = []

    def make(server_cls=ts.EvalServer, daemon_kw=None, **client_kw):
        daemon = ts.EvalDaemon(device="cpu", **(daemon_kw or {})).start()
        server = server_cls(daemon)
        client = ts.EvalClient(server.endpoint, **client_kw)
        made.append((daemon, server, client))
        return daemon, server, client

    yield make
    for daemon, server, client in made:
        client.close()
        server.close()
        daemon.stop()


def _silent_server():
    sock = socket.create_server(("127.0.0.1", 0))
    conns = []

    def loop():
        while True:
            try:
                conn, _ = sock.accept()
            except OSError:
                return
            conns.append(conn)

    threading.Thread(target=loop, daemon=True).start()

    def close():
        sock.close()
        for c in conns:
            c.close()

    host, port = sock.getsockname()[:2]
    return f"{host}:{port}", close


# ------------------------------------------------------ knob validation
DEGENERATE = (0, -1.0, float("nan"), float("inf"), "5")


@pytest.mark.parametrize("knob", ["request_timeout_s", "connect_timeout_s", "backoff_base_s", "backoff_cap_s",
                                  "breaker_reset_s"])  # fmt: skip
def test_client_deadline_knobs_rejected(knob):
    for bad in DEGENERATE:
        with pytest.raises(ValueError, match=knob):
            ts.EvalClient("127.0.0.1:1", **{knob: bad})


@pytest.mark.parametrize("knob", ["max_attempts", "max_in_flight", "breaker_threshold", "replay_capacity"])
def test_client_integer_knobs_validated(knob):
    for bad in (0, -1, 1.5):
        with pytest.raises(ValueError, match=knob):
            ts.EvalClient("127.0.0.1:1", **{knob: bad})


def test_per_call_address_and_daemon_timeouts_validated():
    client = ts.EvalClient("127.0.0.1:1")
    for bad in DEGENERATE:
        with pytest.raises(ValueError, match="timeout_s"):
            client.health(timeout_s=bad)
    with pytest.raises(ValueError, match="address"):
        ts.EvalClient("no-port-here")
    ts.EvalClient("127.0.0.1:1", request_timeout_s=None, connect_timeout_s=0.5, backoff_base_s=0.01).close()
    daemon = ts.EvalDaemon(device="cpu").start()
    for bad in DEGENERATE:
        with pytest.raises(ValueError, match="timeout_s"):
            daemon.drain(timeout=bad)
        with pytest.raises(ValueError, match="timeout_s"):
            daemon.stop(timeout=bad)
    daemon.stop(timeout=5.0)


# ----------------------------------------------------- transport failures
def test_connection_refused_is_retryable_transport_error():
    probe = socket.create_server(("127.0.0.1", 0))
    host, port = probe.getsockname()[:2]
    probe.close()
    client = ts.EvalClient(f"{host}:{port}", max_attempts=2, backoff_base_s=0.01, connect_timeout_s=0.5)
    try:
        t0 = time.monotonic()
        with pytest.raises(ts.WireError) as ctx:
            client.health()
        assert ctx.value.reason == "transport" and ctx.value.retryable
        assert str(port) in ctx.value.endpoint and time.monotonic() - t0 < 5.0
    finally:
        client.close()


def test_silent_server_timeout_and_the_circuit_breaker(obs_on):
    endpoint, close = _silent_server()
    try:
        client = ts.EvalClient(endpoint, request_timeout_s=0.2, max_attempts=2, backoff_base_s=0.01)
        with pytest.raises(ts.WireError) as ctx:
            client.health()
        assert ctx.value.reason == "request_timeout" and ctx.value.retryable
        client.close()
        client = ts.EvalClient(
            endpoint, request_timeout_s=0.1, max_attempts=1, backoff_base_s=0.01, breaker_threshold=2,
            breaker_reset_s=0.3,
        )  # fmt: skip
        for _ in range(2):
            with pytest.raises(ts.WireError):
                client.health()
        t0 = time.monotonic()
        with pytest.raises(ts.WireError) as ctx:
            client.health()
        assert ctx.value.reason == "circuit_open" and time.monotonic() - t0 < 0.05
        time.sleep(0.35)
        with pytest.raises(ts.WireError) as ctx:
            client.health()
        assert ctx.value.reason == "request_timeout"
        client.close()
    finally:
        close()
    counters = tobs.snapshot()["counters"]
    assert any(k.startswith("serve.client.breaker{") and "event=open" in k for k in counters)


def test_breaker_closes_on_success(stack):
    _, _, client = stack(breaker_threshold=2, breaker_reset_s=0.1)
    client._breaker_failure()
    client._breaker_failure()
    time.sleep(0.15)
    client.health()
    assert client._breaker_failures == 0


# ------------------------------------------------------- serve-side retries
def test_backpressure_shed_retries_until_worker_drains(stack, obs_on):
    _, _, client = stack(max_attempts=8, backoff_base_s=0.05, backoff_cap_s=0.2)
    client.attach("t", SPEC, queue_capacity=1)
    scores, labels = _batch()
    for _ in range(6):
        assert client.submit("t", scores, labels)
    assert _acc(client, "t") == _oracle([(scores, labels)] * 6)
    assert client.health()["tenants"]["t"]["processed"] == 6


def test_non_retryable_path_rolls_back_a_clean_reject(stack):
    daemon, _, client = stack(max_attempts=1, backoff_base_s=0.01)
    client.attach("t", SPEC, queue_capacity=1)
    daemon._tenants["t"].capacity = 0
    with pytest.raises(ts.BackpressureError) as ctx:
        client.submit("t", *_batch())
    assert ctx.value.retryable
    st = client._tenant_state("t")
    assert len(st.replay) == 0 and st.next_seq == 1


def test_in_flight_bound_holds_under_concurrency(stack):
    _, _, client = stack(max_in_flight=2)
    peak, live, lock = [0], [0], threading.Lock()
    orig_out, orig_in, orig_discard = client._checkout, client._checkin, client._discard

    def tracking_checkout():
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        return orig_out()

    def tracking_checkin(sock):
        with lock:
            live[0] -= 1
        orig_in(sock)

    def tracking_discard(sock):
        with lock:
            live[0] -= 1
        orig_discard(sock)

    client._checkout, client._checkin, client._discard = tracking_checkout, tracking_checkin, tracking_discard
    threads = [threading.Thread(target=client.health) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert peak[0] <= 2


# ------------------------------------------- ambiguous rejects keep booking
QUARANTINE = {
    "type": "TenantQuarantinedError", "reason": "poisoned_batch", "message": "bad", "tenant": "t",
    "retryable": False,
}  # fmt: skip


def _scripted_server(script):
    sock = socket.create_server(("127.0.0.1", 0))

    def loop():
        while script:
            try:
                conn, _ = sock.accept()
            except OSError:
                return
            with conn:
                while script:
                    try:
                        frame = recv_frame(conn)
                    except Exception:  # noqa: BLE001
                        break
                    if frame is None:
                        break
                    action = script.pop(0)
                    if action == "drop":
                        break
                    if action[0] == "ok":
                        send_frame(conn, {"ok": True, **action[1]})
                    else:
                        send_frame(conn, {"ok": False, "error": action[1]})

    threading.Thread(target=loop, daemon=True).start()
    host, port = sock.getsockname()[:2]
    return f"{host}:{port}", sock


def _scripted_client(script):
    endpoint, sock = _scripted_server(script)
    client = ts.EvalClient(endpoint, max_attempts=2, backoff_base_s=0.01, request_timeout_s=5.0)
    with client._lock:
        client._tenants["t"] = _ClientTenant(0)
    return client, sock


def test_reject_after_ambiguous_attempt_stays_booked():
    client, sock = _scripted_client(["drop", ("error", QUARANTINE)])
    try:
        with pytest.raises(ts.TenantQuarantinedError) as ctx:
            client.submit("t", *_batch())
        assert getattr(ctx.value, "batch_booked", False)
        st = client._tenant_state("t")
        assert [s for s, _ in st.replay] == [1] and st.next_seq == 2
    finally:
        client.close()
        sock.close()


def test_booked_transport_failure_resends_before_next_batch():
    script = ["drop", "drop", ("ok", {"applied": True, "acked_seq": 0}), ("ok", {"applied": True, "acked_seq": 0})]
    client, sock = _scripted_client(script)
    try:
        with pytest.raises(ts.WireError) as ctx:
            client.submit("t", *_batch())
        assert getattr(ctx.value, "batch_booked", False)
        st = client._tenant_state("t")
        assert st.needs_resend
        assert client.submit("t", *_batch())
        assert not st.needs_resend and [s for s, _ in st.replay] == [1, 2] and script == []
    finally:
        client.close()
        sock.close()


def test_clean_first_attempt_reject_rolls_back():
    client, sock = _scripted_client([("error", QUARANTINE)])
    try:
        with pytest.raises(ts.TenantQuarantinedError):
            client.submit("t", *_batch())
        st = client._tenant_state("t")
        assert len(st.replay) == 0 and st.next_seq == 1
    finally:
        client.close()
        sock.close()


def test_export_adopt_replays_only_undurable_tail(stack):
    _, _, client = stack()
    client.attach("t", SPEC)
    scores, labels = _batch()
    for _ in range(4):
        client.submit("t", scores, labels)
    client.flush("t")
    for _ in range(2):
        client.submit("t", scores, labels)
    exported = client.export_tenant("t")
    assert exported["durable_seq"] == 4 and [s for s, _ in exported["replay"]] == [5, 6]
    daemon2, _, client2 = stack()
    client2.attach("t", SPEC)
    assert client2.adopt_tenant("t", exported, restored_seq=4) == 2
    client2.compute("t")
    assert daemon2.health()["tenants"]["t"]["processed"] == 2
    assert client2._tenant_state("t").next_seq == 7
    # the router's other two ops run on a client alone
    client2.adopt_attached("u", 5)
    assert client2._tenant_state("u").next_seq == 6
    assert client.drop_tenant("t", checkpoint=False) is None


# -------------------------------------------------------- local transport
class _SpyHandle:
    def __init__(self):
        self.captured = []
        self._tenant = type("T", (), {"durable_seq": 0, "last_seq": 0})()

    def submit(self, *args, seq=None, stage=None, **kw):
        self.captured.append((args, stage))
        if stage is not None:
            stage.release()
        return True


def _spy(server, tenant="t"):
    spy = _SpyHandle()
    with server._lock:
        server._handles[tenant] = spy
    return spy


def test_endpoint_registry_and_closed_server():
    daemon = ts.EvalDaemon(device="cpu").start()
    try:
        server = ts.EvalServer(daemon)
        assert local_server(server.endpoint) is server
        server.close()
        assert local_server(server.endpoint) is None
        with pytest.raises(OSError):
            server.local_request({"op": "submit", "tenant": "t"}, b"")
    finally:
        daemon.stop()


def test_bytes_payload_decodes_as_views_no_stage(stack):
    _, server, client = stack()
    client.attach("t", SPEC)
    spy = _spy(server)
    scores, labels = _batch(n=256)
    assert client.submit("t", scores, labels)
    ((args, stage),) = spy.captured
    assert stage is None and all(not leaf.flags.owndata for leaf in args)
    np.testing.assert_array_equal(args[0], scores)
    np.testing.assert_array_equal(args[1], labels)


def test_scatter_gather_payload_lands_in_one_pool_slot(stack):
    _, server, client = stack(submit_buffer=4)
    client.attach("t", SPEC)
    spy = _spy(server)
    batches = [_batch(seed=i, n=256) for i in range(4)]
    for s, l in batches:
        assert client.submit("t", s, l)
    assert len(spy.captured) == 4
    assert len({id(stage) for _a, stage in spy.captured}) == 1
    assert isinstance(spy.captured[0][1], SharedStage)
    for (args, _stage), (s, l) in zip(spy.captured, batches):
        np.testing.assert_array_equal(args[0], s)
        np.testing.assert_array_equal(args[1], l)
        assert all(not leaf.flags.owndata for leaf in args)


def test_local_dispatch_allocates_nothing_per_call(stack):
    _, server, client = stack()
    client.attach("t", SPEC)
    spy = _spy(server)
    spec, blob = pack_tree(list(_batch(n=8192)))
    header = {"op": "submit", "tenant": "t", "seq": 1, "args": spec}
    for _ in range(3):
        server.local_request(dict(header), blob)
    spy.captured.clear()
    tracemalloc.start()
    try:
        snap0 = tracemalloc.take_snapshot()
        for _ in range(20):
            server.local_request(dict(header), blob)
        snap1 = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = sum(d.size_diff for d in snap1.compare_to(snap0, "filename") if d.size_diff > 0)
    assert len(spy.captured) == 20 and grown / 20 < 8192


def test_local_and_tcp_bit_identical_with_accounting(stack, obs_on):
    _, server, local = stack()
    tcp = ts.EvalClient(server.endpoint, local_transport=False)
    try:
        batches = [_batch(seed=i, n=256) for i in range(6)]
        results = []
        for client, tenant in ((local, "t-local"), (tcp, "t-tcp")):
            client.attach(tenant, SPEC)
            for s, l in batches:
                assert client.submit(tenant, s, l)
            results.append(_acc(client, tenant))
            if client is local:
                avoided = tobs.snapshot()["counters"].get("serve.ingest.local_copies_avoided_bytes", 0.0)
                assert avoided > 0.0
        assert results[0] == results[1] == _oracle(batches)
        assert tobs.snapshot()["counters"]["serve.ingest.local_copies_avoided_bytes"] == avoided
        for tid in ("t-local", "t-tcp"):
            health = local.health()["tenants"][tid]
            assert (health["processed"], health["dupes"]) == (6, 0)
        for client in (local, tcp):
            with pytest.raises(ts.ServeError) as ctx:
                client.submit("ghost", *_batch())
            assert ctx.value.reason == "unknown_tenant"
    finally:
        tcp.close()


def test_tcp_fallback_when_endpoint_not_local(stack, obs_on):
    _, server, client = stack()
    client.attach("t", SPEC)
    with twire._LOCAL_SERVERS_LOCK:
        del twire._LOCAL_SERVERS[server.endpoint]
    try:
        assert client.submit("t", *_batch(seed=0, n=256))
        assert tobs.snapshot()["counters"].get("serve.ingest.local_copies_avoided_bytes", 0.0) == 0.0
    finally:
        with twire._LOCAL_SERVERS_LOCK:
            twire._LOCAL_SERVERS[server.endpoint] = server
    assert client.submit("t", *_batch(seed=1, n=256))
    assert tobs.snapshot()["counters"]["serve.ingest.local_copies_avoided_bytes"] > 0.0
    assert _acc(client, "t") == _oracle([_batch(seed=0, n=256), _batch(seed=1, n=256)])


# ---------------------------------------------------------- obs push channel
def _wait(predicate, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def _no_obs_threads():
    return not [t.name for t in threading.enumerate() if "torcheval-tpu-obs-" in t.name]


ZEROS = (np.zeros(8, np.int64), np.zeros(8, np.int64))
SPEC4 = {"acc": ts.metric_spec("MulticlassAccuracy", num_classes=4)}


class _OldServer(ts.EvalServer):
    def _handle(self, op, header, payload, stage_box=None):
        if op == "subscribe_obs":
            raise ts.WireError("protocol", f"unknown wire op {op!r}.")
        return super()._handle(op, header, payload, stage_box)


def _streamed(stack, server_cls=ts.EvalServer):
    return stack(server_cls=server_cls, request_timeout_s=30.0, max_attempts=2, backoff_base_s=0.01)


def test_push_delivers_deltas_and_load_report(stack, obs_on):
    _, server, client = _streamed(stack)
    client.attach("t1", SPEC4)
    pushes = []
    sub = client.subscribe_obs(0.1, on_push=pushes.append)
    try:
        assert sub.mode == "push"
        client.submit("t1", *ZEROS)
        assert _wait(lambda: sub.received >= 2)
        msg = sub.last
        assert (msg["op"], msg["endpoint"]) == ("obs_push", server.endpoint)
        assert msg["delta"]["v"] == 1 and msg["load_report"]["schema"] == 1
        seqs = [p["push_seq"] for p in pushes]
        assert seqs == sorted(seqs) and pushes[0]["delta"]["full"]
    finally:
        sub.stop()


def test_deltas_fold_to_the_host_registry(stack, obs_on):
    _, _, client = _streamed(stack)
    client.attach("t1", SPEC4)
    acc = DeltaAccumulator()
    sub = client.subscribe_obs(0.05, on_push=lambda m: acc.apply(m["delta"]))
    try:
        for _ in range(3):
            client.submit("t1", *ZEROS)
        assert _wait(lambda: acc.snapshot()["counters"].get("serve.ingest.batches{tenant=t1}") == 3.0)
    finally:
        sub.stop()


def test_drain_final_flush_reaches_subscriber(stack, obs_on):
    _, _, client = _streamed(stack)
    client.attach("t1", SPEC4)
    sub = client.subscribe_obs(30.0)
    try:
        client.submit("t1", *ZEROS)
        client.drain()
        assert _wait(lambda: sub.received >= 1)
        assert "serve.ingest.batches{tenant=t1}" in sub.last["delta"]["counters"]
    finally:
        sub.stop()


def test_subscription_lifecycles_retire_their_threads(stack, obs_on):
    _, server, client = _streamed(stack)
    sub = client.subscribe_obs(0.05)
    assert _wait(lambda: sub.received >= 2)
    assert tobs.snapshot()["counters"].get("obs.stream.pushes", 0) >= 2
    sub.stop()
    assert not sub.alive and _wait(_no_obs_threads)
    sub = client.subscribe_obs(0.05)
    client.close()
    assert _wait(lambda: not sub.alive) and _wait(_no_obs_threads)
    client2 = ts.EvalClient(server.endpoint)
    sub = client2.subscribe_obs(30.0)
    server.close()
    assert _wait(lambda: sub.received >= 1) and _wait(lambda: not sub.alive)
    sub.stop()
    client2.close()


def test_bad_interval_and_zero_collective_rounds(stack, obs_on):
    _, _, client = _streamed(stack)
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError):
            client.subscribe_obs(bad)
    client.attach("t1", SPEC4)
    before = tobs.snapshot()["counters"].get("toolkit.sync.rounds", 0)
    sub = client.subscribe_obs(0.05)
    try:
        client.submit("t1", *ZEROS)
        assert _wait(lambda: sub.received >= 3)
        assert tobs.snapshot()["counters"].get("toolkit.sync.rounds", 0) == before
    finally:
        sub.stop()


def test_old_server_degrades_to_polling(stack, obs_on):
    _, _, client = _streamed(stack, _OldServer)
    client.attach("t1", SPEC4)
    sub = client.subscribe_obs(0.1, on_push=lambda m: None)
    try:
        assert sub.mode == "poll"
        assert _wait(lambda: sub.received >= 1)
        msg = sub.last
        assert msg["op"] == "obs_poll" and msg["load_report"]["schema"] == 1 and "health" in msg
    finally:
        sub.stop()
    with pytest.raises(ts.WireError) as ctx:
        client.subscribe_obs(0.1, fallback="raise")
    assert ctx.value.reason == "protocol"
    with pytest.raises(ValueError):
        client.subscribe_obs(0.1, fallback="maybe")
