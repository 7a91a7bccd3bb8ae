"""The port's eval wire on the CPU: framing, tree coding, codecs, metric
specs, the ``EvalServer`` ops and the error marshalling.

Counterparts: ``tests/serve/test_wire.py``, ``test_wire_codec.py`` and
``test_errors_retryable.py``. Every frame the port packs is held to the
JAX package's ``pack_tree`` / ``pack_tree_parts`` byte for byte under
``raw``, ``delta`` and ``qblk`` (cross-package decoding is in
``test_torch_serve_interop.py``). Every socket binds port 0.
"""

import os
import socket
import struct
import threading

import numpy as np
import pytest
import torch

import torcheval_tpu.serve.wire as jwire
import torcheval_tpu_torch.metrics as tm
import torcheval_tpu_torch.serve as ts
from torcheval_tpu_torch import obs as tobs
from torcheval_tpu_torch.resilience.snapshot import CheckpointError, list_checkpoints
from torcheval_tpu_torch.serve import wire as twire
from torcheval_tpu_torch.serve.wire import (
    WIRE_CODECS,
    build_metrics,
    decode_error,
    encode_error,
    pack_tree,
    pack_tree_parts,
    recv_frame,
    send_frame,
    unpack_tree,
)
from torcheval_tpu_torch.utils import quant

C = 5
SPEC = {"acc": ts.metric_spec("MulticlassAccuracy", num_classes=C)}


def _batch(seed=0, n=16):
    rng = np.random.default_rng(seed)
    return rng.random((n, C)).astype(np.float32), rng.integers(0, C, n)


def _tacc():
    return tm.MulticlassAccuracy(num_classes=C, device="cpu")


def _oracle_bytes(batches):
    m = _tacc()
    for s, l in batches:
        m.update(s, l)
    return np.asarray(m.compute()).tobytes()


def _val(x):
    return np.asarray(x).tobytes()


@pytest.fixture
def pipe():
    a, b = socket.socketpair()
    yield a, b
    a.close()
    b.close()


# ------------------------------------------------------------- framing
def test_frame_roundtrip_header_and_payload(pipe):
    a, b = pipe
    send_frame(a, {"op": "x", "n": 3}, b"\x00\x01binary\xff")
    assert recv_frame(b) == ({"op": "x", "n": 3}, b"\x00\x01binary\xff")
    send_frame(a, {"op": "health"})
    assert recv_frame(b) == ({"op": "health"}, b"")
    a.close()
    assert recv_frame(b) is None


@pytest.mark.parametrize("raw", [b"HTTP/1.1 200 OK\r\n\r\n", struct.pack(">4sIQ", b"TEW1", 2, 10) + b"{}123"])
def test_bad_or_truncated_frames_are_protocol_errors(pipe, raw):
    a, b = pipe
    a.sendall(raw)
    a.close()
    with pytest.raises(ts.WireError) as ctx:
        recv_frame(b)
    assert ctx.value.reason == "protocol" and not ctx.value.retryable


# ---------------------------------------------------------- tree coding
def test_roundtrip_nested_tree_exact_dtypes():
    tree = {
        "acc": np.float32(0.5),
        "curve": (np.arange(5, dtype=np.int64), np.linspace(0, 1, 5, dtype=np.float64)),
        "meta": {"n": 3, "name": "x", "flag": True, "none": None},
        "list": [np.float16([1.5, 2.5]), 7],
    }
    spec, payload = pack_tree(tree)
    got = unpack_tree(spec, payload)
    assert set(got) == set(tree) and isinstance(got["curve"], tuple)
    assert (got["curve"][0].dtype, got["curve"][1].dtype, got["list"][0].dtype) == (
        np.int64, np.float64, np.float16)  # fmt: skip
    np.testing.assert_array_equal(got["curve"][0], tree["curve"][0])
    assert got["meta"] == tree["meta"]
    assert pack_tree({"a": 1}) == ({"t": "dict", "k": [{"t": "py", "v": "a"}], "v": [{"t": "py", "v": 1}]}, b"")


def test_torch_tensors_marshal_as_numpy():
    t = torch.arange(4.0)
    spec, payload = pack_tree({"v": t, "i": torch.tensor([1, 2], dtype=torch.int64)})
    got = unpack_tree(spec, payload)
    np.testing.assert_array_equal(got["v"], np.arange(4.0, dtype=np.float32))
    assert got["i"].dtype == np.int64
    # the same tree as the JAX package packs from numpy, byte for byte
    assert (spec, payload) == jwire.pack_tree({"v": t.numpy(), "i": np.array([1, 2])})


def test_unmarshalable_and_malformed_are_protocol_errors():
    with pytest.raises(ts.WireError):
        pack_tree({"f": lambda: None})
    with pytest.raises(ts.WireError):
        unpack_tree({"t": "nope"}, b"")


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "batch": [(rng.random((128, 5)) * 3).astype(np.float32), rng.integers(0, 5, 128)],
        "ids": np.cumsum(rng.integers(0, 9, 300)).astype(np.int64),
        "small": np.float32([1.25, -2.5]),
        "nan": np.full(1024, np.nan, np.float32),
        "meta": (1, "x", None),
    }


def _assemble(parts):
    return b"".join(bytes(memoryview(p).cast("B")) for p in parts)


@pytest.mark.parametrize("codec", ["raw", "delta", "qblk"])
def test_frames_are_the_jax_packages_byte_for_byte(codec):
    tree = _tree(3)
    assert pack_tree(tree, codec=codec) == jwire.pack_tree(tree, codec=codec)
    spec, parts, total = pack_tree_parts(tree, codec=codec)
    jspec, jparts, jtotal = jwire.pack_tree_parts(tree, codec=codec)
    assert (spec, total) == (jspec, jtotal)
    assert _assemble(parts) == _assemble(jparts)


def test_codec_trees_lossless_ints_bounded_floats_and_smaller():
    tree = _tree(4)
    raw_len = len(pack_tree(tree)[1])
    for codec in ("delta", "qblk"):
        spec, blob = pack_tree(tree, codec=codec)
        out = unpack_tree(spec, blob)
        assert len(blob) < raw_len
        np.testing.assert_array_equal(out["batch"][1], tree["batch"][1])
        np.testing.assert_array_equal(out["ids"], tree["ids"])
        np.testing.assert_array_equal(out["small"], tree["small"])
        np.testing.assert_array_equal(out["nan"], tree["nan"])
        assert out["meta"] == (1, "x", None)
        scores = tree["batch"][0]
        if codec == "delta":
            np.testing.assert_array_equal(out["batch"][0], scores)
        else:
            assert np.abs(out["batch"][0] - scores).max() <= np.abs(scores).max() / 254 * 1.000001
            assert out["batch"][0].dtype == scores.dtype
    spec, blob = pack_tree([np.arange(100, dtype=np.int64)], codec="delta")
    spec["v"][0]["sh"] = [999_999]
    with pytest.raises(ts.WireError) as ctx:
        unpack_tree(spec, blob)
    assert ctx.value.reason == "protocol"


# --------------------------------------------------------- metric specs
def test_build_metrics_on_the_servers_device():
    out = build_metrics({"acc": ts.metric_spec("MulticlassAccuracy", num_classes=7)}, device="cpu")
    assert isinstance(out["acc"], tm.MulticlassAccuracy) and out["acc"].device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_metrics({"acc": ts.metric_spec("MulticlassAccuracy", num_classes=7)})


@pytest.mark.parametrize(
    "spec",
    [{"m": ["NotAMetric", {}]}, {"m": ["os", {}]}, {"m": ["Metric.__subclasses__", {}]},
     {"m": ["MulticlassAccuracy", {"no_such_kwarg": 5}]}, {"m": ["MulticlassAccuracy", {"device": "cuda"}]},
     {"m": "MulticlassAccuracy"}, [], {}],
)  # fmt: skip
def test_bad_specs_reject_bad_metrics(spec):
    with pytest.raises(ts.AdmissionError) as ctx:
        build_metrics(spec, device="cpu")
    assert ctx.value.reason == "bad_metrics"


def test_both_namespaces_export_the_same_metrics():
    import torcheval_tpu.metrics as jm

    assert set(tm.__all__) == set(jm.__all__)


# ------------------------------------------------------------ server ops
@pytest.fixture
def served(tmp_path):
    tobs.reset()
    daemon = ts.EvalDaemon(device="cpu", evict_dir=str(tmp_path)).start()
    server = ts.EvalServer(daemon)
    client = ts.EvalClient(server.endpoint, request_timeout_s=30.0, max_attempts=2, backoff_base_s=0.01)
    yield daemon, server, client, str(tmp_path)
    client.close()
    server.close()
    daemon.stop()
    tobs.disable()
    tobs.reset()


def test_submit_compute_matches_local_oracle(served):
    _, server, client, _ = served
    assert server.device == torch.device("cpu") and server._pool.device == torch.device("cpu")
    client.attach("t1", SPEC)
    scores, labels = _batch()
    for _ in range(4):
        client.submit("t1", scores, labels)
    assert _val(client.compute("t1")["acc"]) == _oracle_bytes([(scores, labels)] * 4)


def test_duplicate_seq_not_reapplied(served):
    _, _, client, _ = served
    tobs.enable()
    client.attach("t1", SPEC)
    scores, labels = _batch()
    st = client._tenant_state("t1")
    assert client.submit("t1", scores, labels)
    spec, blob = pack_tree([scores, labels])
    header, _ = client._call("submit", {"tenant": "t1", "seq": 1, "args": spec}, blob)
    assert not header["applied"]
    assert _val(client.compute("t1")["acc"]) == _oracle_bytes([(scores, labels)])
    counters = tobs.snapshot()["counters"]
    assert counters.get("serve.ingest.batches{tenant=t1}") == 1.0
    assert counters.get("serve.ingest.dupes{tenant=t1}") == 1.0
    assert st.next_seq == 2


def test_flush_advances_durable_watermark_and_prunes_replay(served):
    _, _, client, _ = served
    client.attach("t1", SPEC)
    scores, labels = _batch()
    st = client._tenant_state("t1")
    for _ in range(3):
        client.submit("t1", scores, labels)
    assert len(st.replay) == 3
    out = client.flush("t1")
    assert os.path.isdir(out["path"]) and out["acked_seq"] == 3 and len(st.replay) == 0
    client.submit("t1", scores, labels)
    assert _val(client.compute("t1")["acc"]) == _oracle_bytes([(scores, labels)] * 4)
    health = client.health()["tenants"]["t1"]
    assert (health["last_seq"], health["durable_seq"]) == (4, 3)


def test_replay_valve_flushes_when_buffer_full(served):
    _, server, _, _ = served
    client = ts.EvalClient(server.endpoint, replay_capacity=2, backoff_base_s=0.01)
    try:
        client.attach("t2", SPEC)
        st = client._tenant_state("t2")
        for _ in range(5):
            client.submit("t2", *_batch())
            assert len(st.replay) <= 2
        assert st.durable_seq >= 2
    finally:
        client.close()


def test_structured_errors_and_knobs_cross_the_wire(served):
    _, _, client, _ = served
    client.attach("t1", SPEC)
    with pytest.raises(ts.AdmissionError) as ctx:
        client.attach("t1", SPEC)
    assert ctx.value.reason == "duplicate_tenant" and not ctx.value.retryable
    with pytest.raises(ts.ServeError) as ctx:
        client.compute("ghost")
    assert ctx.value.reason == "unknown_tenant"
    for bad in (0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError):
            client.attach("tv", SPEC, step_timeout_s=bad)
    with pytest.raises(ts.WireError) as ctx:
        client._call("frobnicate", {})
    assert ctx.value.reason == "protocol"
    assert not client.health()["draining"]


def test_detach_snapshot_and_sync_compute_ops(served):
    _, _, client, _ = served
    tobs.enable()
    client.attach("t1", SPEC)
    client.submit("t1", *_batch())
    snap = client.snapshot()
    assert "counters" in snap["snapshot"] and "traceEvents" in snap["trace"]
    got = client.sync_compute("t1", sync_timeout_s=30.0, on_failure="local")
    assert _val(got["acc"]) == _val(client.compute("t1")["acc"])
    assert os.path.isdir(client.detach("t1", checkpoint=True))
    client.attach("once", SPEC)
    assert client.detach("once") is None
    assert client.detach("once") is None  # idempotent


def test_drain_evicts_all_rejects_new_work_and_resumes_elsewhere(served):
    _, _, client, root = served
    client.attach("a", SPEC)
    client.attach("b", SPEC)
    scores, labels = _batch()
    for _ in range(3):
        client.submit("a", scores, labels)
    drained = client.drain()
    assert set(drained) == {"a", "b"} and all(os.path.isdir(p) for p in drained.values())
    with pytest.raises(ts.AdmissionError) as ctx:
        client.attach("c", SPEC)
    assert ctx.value.reason == "draining" and not ctx.value.retryable
    assert client.health()["draining"]
    daemon2 = ts.EvalDaemon(device="cpu", evict_dir=root).start()
    server2 = ts.EvalServer(daemon2)
    client2 = ts.EvalClient(server2.endpoint)
    try:
        assert client2.attach("a", SPEC, resume="require")["last_seq"] == 3
        client2.submit("a", scores, labels)
        assert _val(client2.compute("a")["acc"]) == _oracle_bytes([(scores, labels)] * 4)
    finally:
        client2.close()
        server2.close()
        daemon2.stop()


def test_attach_retry_with_same_nonce_reacked_as_success(served):
    _, _, client, _ = served
    header, _ = client._call("attach", {"tenant": "amb", "spec": SPEC, "nonce": "n-1"})
    assert header["last_seq"] == 0
    retry, _ = client._call("attach", {"tenant": "amb", "spec": SPEC, "nonce": "n-1"})
    assert retry["ok"] and retry["last_seq"] == 0
    with pytest.raises(ts.AdmissionError) as ctx:
        client._call("attach", {"tenant": "amb", "spec": SPEC, "nonce": "n-2"})
    assert ctx.value.reason == "duplicate_tenant"


def test_aborted_idle_eviction_never_deletes_the_durable_checkpoint(tmp_path):
    daemon = ts.EvalDaemon(device="cpu", evict_dir=str(tmp_path), evict_keep_last=1).start()
    try:
        handle = daemon.attach("t", {"acc": _tacc()})
        scores, labels = _batch()
        handle.submit(scores, labels)
        durable = handle.flush(timeout=60)["path"]
        tenant = daemon._tenants["t"]
        orig = daemon._checkpoint_tenant

        def racing_checkpoint(t, **kw):
            path = orig(t, **kw)
            with daemon._cond:
                t.queue.append(("batch", (None, (scores, labels)), None))
            return path

        daemon._checkpoint_tenant = racing_checkpoint
        tenant.watchdog_timeout_s = 0.0
        daemon._evict_idle(tenant)
        daemon._checkpoint_tenant = orig
        assert "t" in daemon._tenants
        assert durable in list_checkpoints(os.path.join(str(tmp_path), "t"))
    finally:
        daemon.stop()


def test_garbage_speaker_and_concurrent_producers(served):
    _, server, client, _ = served
    with socket.create_connection(server.address) as sock:
        sock.sendall(b"GET / HTTP/1.1\r\n\r\n")
    client.attach("shared", SPEC)
    scores, labels = _batch()
    errors = []

    def worker():
        try:
            for _ in range(3):
                client.submit("shared", scores, labels)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == [] and client.health()["tenants"]["shared"]["ingested"] == 12


# ------------------------------------------------------ codec negotiation
@pytest.fixture(scope="module")
def codec_batches():
    rng = np.random.default_rng(6)
    return [(rng.random((64, C)).astype(np.float32), rng.integers(0, C, 64)) for _ in range(6)]


def _codec_run(batches, server_codecs, client_codec, submit_buffer=1):
    with ts.EvalDaemon(device="cpu") as daemon:
        server = ts.EvalServer(daemon, codecs=server_codecs)
        client = ts.EvalClient(server.endpoint, codec=client_codec, submit_buffer=submit_buffer)
        try:
            ack = client.attach("t", SPEC)
            for s, l in batches:
                client.submit("t", s, l)
            return ack, _val(client.compute("t")["acc"])
        finally:
            client.close()
            server.close()


@pytest.mark.parametrize(
    "server_codecs,client_codec,negotiated",
    [((), "qblk", "raw"), (WIRE_CODECS, "raw", "raw"), (WIRE_CODECS, "delta", "delta"), (("delta",), "qblk", "delta")],
)
def test_codec_negotiation_is_lossless_unless_qblk(codec_batches, server_codecs, client_codec, negotiated):
    ack, value = _codec_run(codec_batches, server_codecs, client_codec)
    assert ack["codec"] == negotiated
    assert value == _oracle_bytes(codec_batches)


def test_qblk_submit_many_within_documented_drift(codec_batches):
    ack, value = _codec_run(codec_batches, WIRE_CODECS, "qblk", submit_buffer=3)
    assert ack["codec"] == "qblk"
    dequantized = [(quant.q8_from_parts(*quant.q8_parts(s), s.shape), l) for s, l in codec_batches]
    assert value == _oracle_bytes(dequantized)


def test_codec_obs_counters_and_knob(codec_batches, monkeypatch):
    tobs.reset()
    tobs.enable()
    try:
        _codec_run(codec_batches, WIRE_CODECS, "delta")
        counters = tobs.snapshot()["counters"]
        assert counters.get("serve.wire.codec{codec=delta}", 0) >= 1
        raw = counters["serve.client.payload_raw_bytes{codec=delta}"]
        enc = counters["serve.client.payload_bytes{codec=delta}"]
        assert 0 < raw and enc < raw + 4096
        assert counters["serve.wire.rx_bytes{codec=delta}"] >= enc
    finally:
        tobs.disable()
        tobs.reset()
    monkeypatch.delenv("TORCHEVAL_TPU_WIRE_CODEC", raising=False)
    assert quant.wire_codec_default() == "raw"
    monkeypatch.setenv("TORCHEVAL_TPU_WIRE_CODEC", "qblk")
    assert quant.wire_codec_default() == "qblk"
    client = ts.EvalClient("127.0.0.1:1")
    assert client._codec_pref == "qblk"
    client.close()


# ---------------------------------------------------- retry classification
@pytest.mark.parametrize(
    "exc,retryable",
    [
        (ts.BackpressureError("queue_full", "full", tenant="t"), True),
        (ts.AdmissionError("capacity", "at max_tenants"), True),
        *[(ts.AdmissionError(r, "nope"), False)
          for r in ("duplicate_tenant", "bad_metrics", "daemon_stopped", "no_checkpoint", "draining")],
        *[(ts.TenantQuarantinedError(r, "bad", tenant="t"), False)
          for r in ("poisoned_batch", "nan_policy", "compute_error", "step_timeout")],
        (ts.TenantEvictedError("watchdog_idle", "gone", tenant="t", checkpoint="/ckpt"), False),
        *[(ts.ServeError(r, "nope"), False) for r in ("daemon_stopped", "draining", "unknown_tenant")],
        *[(ts.WireError(r, "net"), True) for r in ("transport", "request_timeout", "circuit_open")],
        (ts.WireError("protocol", "skew"), False),
    ],
)  # fmt: skip
def test_retryable_classification(exc, retryable):
    assert exc.retryable is retryable
    got = decode_error(encode_error(exc))
    assert type(got) is type(exc)
    assert (got.reason, got.retryable) == (exc.reason, exc.retryable)
    assert str(got).count(f"[{exc.reason}]") == 1
    for field in ("tenant", "checkpoint"):
        assert getattr(got, field, None) == getattr(exc, field, None)


def test_error_marshalling_special_cases():
    got = decode_error(encode_error(CheckpointError("schema_mismatch", "drift")))
    assert isinstance(got, CheckpointError) and got.reason == "schema_mismatch"
    assert not getattr(got, "retryable", False)
    got = decode_error(encode_error(ValueError("timeout_s must be positive")))
    assert isinstance(got, ValueError) and "timeout_s" in str(got)
    got = decode_error(encode_error(ts.TenantError("weird", "odd", tenant="t")))
    assert isinstance(got, ts.TenantError)
    got = decode_error({"type": "SomethingNew", "reason": "later", "message": "m", "retryable": True})
    assert isinstance(got, ts.ServeError) and got.reason == "later" and got.retryable


def test_the_wire_keeps_its_own_local_registry():
    assert twire._LOCAL_SERVERS is not jwire._LOCAL_SERVERS
    with ts.EvalDaemon(device="cpu") as daemon:
        server = ts.EvalServer(daemon)
        try:
            assert twire.local_server(server.endpoint) is server
            assert jwire.local_server(server.endpoint) is None
        finally:
            server.close()
        assert twire.local_server(server.endpoint) is None


def test_tcp_frames_land_in_pooled_slots(served):
    _, server, _, _ = served
    client = ts.EvalClient(server.endpoint, local_transport=False)
    try:
        client.attach("t", SPEC)
        batches = [_batch(seed=i, n=4096) for i in range(3)]
        for s, l in batches:
            client.submit("t", s, l)
        assert _val(client.compute("t")["acc"]) == _oracle_bytes(batches)
    finally:
        client.close()
    stats = server._pool.stats()
    assert stats["allocated"] >= 1 and stats["free"] >= 1


def _wire_scenario(S, daemon):
    """attach (delta codec), three submits through ``submit_many`` frames
    of two, a duplicate replay, compute and detach, over TCP."""
    server = S.EvalServer(daemon)
    client = S.EvalClient(server.endpoint, codec="delta", submit_buffer=2, local_transport=False)
    try:
        client.attach("t", SPEC)
        for i in range(3):
            client.submit("t", *_batch(seed=40 + i, n=64))
        spec, blob = (jwire if S is not ts else twire).pack_tree(list(_batch(seed=40, n=64)))
        client.compute("t")
        client._call("submit", {"tenant": "t", "seq": 1, "args": spec}, blob)
        client.detach("t")
    finally:
        client.close()
        server.close()


def test_wire_counters_equal_the_jax_packages():
    """The same exchange through each package's server and client: every
    ``serve.*`` counter of the wire, the ingest and the client is equal,
    received bytes included (the frames are the same bytes)."""
    import torcheval_tpu.serve as js
    from torcheval_tpu import obs as jobs

    for o in (jobs, tobs):
        o.reset()
        o.enable()
    try:
        with ts.EvalDaemon(device="cpu") as daemon:
            _wire_scenario(ts, daemon)
        with js.EvalDaemon() as daemon:
            _wire_scenario(js, daemon)
        got, want = ({k: v for k, v in o.snapshot()["counters"].items()
                      if k.startswith("serve.") and not k.startswith("serve.ingest.pool")}
                     for o in (tobs, jobs))
    finally:
        for o in (jobs, tobs):
            o.disable()
            o.reset()
    assert got == want
    for key in ("serve.wire.rx_bytes{codec=delta}", "serve.wire.requests{op=submit_many}",
                "serve.ingest.dupes{tenant=t}", "serve.client.payload_bytes{codec=delta}", "serve.ingest.h2d_bytes"):
        assert got.get(key, 0) > 0, key
