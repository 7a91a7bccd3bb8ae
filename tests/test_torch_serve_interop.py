"""The two packages on one wire: a JAX ``EvalClient`` drives a torch
``EvalServer`` and a torch client drives a JAX server, over loopback TCP.

Each package keeps its own same-process registry, so a client never finds
the other package's server there and speaks TCP. Both directions run
attach, submit (lock-step and pipelined, under ``raw``, ``delta`` and
``qblk``), flush, compute and detach; the served values equal a direct
collection of the server's package bit for bit under ``raw`` and
``delta``, and equal it on the dequantized batches under ``qblk`` (the
codec's bound). Frames packed by either package decode in the other, every
``ServeError`` subclass crosses with its class, ``reason`` and
``retryable``, and a tenant evicted by one package's daemon resumes in the
other's.

Mixed fleets: a router of either package fronts a JAX host and a torch
host on one checkpoint root, over TCP; a tenant drained off one host
resumes on the other from the checkpoint that host's package wrote and
computes the one-stream value.
"""

import numpy as np
import pytest

import torcheval_tpu.metrics as jm
import torcheval_tpu.serve as js
import torcheval_tpu.serve.wire as jwire
import torcheval_tpu_torch.metrics as tm
import torcheval_tpu_torch.serve as ts
import torcheval_tpu_torch.serve.wire as twire
from torcheval_tpu.resilience.snapshot import CheckpointError as JCheckpointError
from torcheval_tpu_torch.resilience.snapshot import CheckpointError as TCheckpointError
from torcheval_tpu_torch.utils import quant

C = 5
SPEC = {
    "acc": ts.metric_spec("MulticlassAccuracy", num_classes=C),
    "f1": ts.metric_spec("MulticlassF1Score", num_classes=C, average="macro"),
}
PKGS = {"jax": js, "torch": ts}
OTHER = {"jax": "torch", "torch": "jax"}


def _batches(n=6, seed=0, rows=64):
    rng = np.random.default_rng(seed)
    return [(rng.random((rows, C)).astype(np.float32), rng.integers(0, C, rows)) for _ in range(n)]


def _daemon(pkg, **kw):
    return ts.EvalDaemon(device="cpu", **kw) if pkg == "torch" else js.EvalDaemon(**kw)


def _direct(pkg, batches):
    """The server package's own collection fed the same batches."""
    if pkg == "torch":
        col = tm.MetricCollection(
            {"acc": tm.MulticlassAccuracy(num_classes=C, device="cpu"),
             "f1": tm.MulticlassF1Score(num_classes=C, average="macro", device="cpu")}
        )  # fmt: skip
    else:
        col = jm.MetricCollection(
            {"acc": jm.MulticlassAccuracy(num_classes=C), "f1": jm.MulticlassF1Score(num_classes=C, average="macro")}
        )
    for s, l in batches:
        col.update(s, l)
    return {k: np.asarray(v) for k, v in col.compute().items()}


def _dequantized(batches):
    return [(quant.q8_from_parts(*quant.q8_parts(s), s.shape), l) for s, l in batches]


@pytest.fixture
def crossed(tmp_path):
    """``make(server_pkg, **client_kw)``: a server of ``server_pkg`` and a
    client of the other package, closed at teardown."""
    made = []

    def make(server_pkg, daemon_kw=None, **client_kw):
        daemon = _daemon(server_pkg, **(daemon_kw or {})).start()
        server = PKGS[server_pkg].EvalServer(daemon)
        client = PKGS[OTHER[server_pkg]].EvalClient(server.endpoint, request_timeout_s=60.0, **client_kw)
        made.append((daemon, server, client))
        return daemon, server, client

    yield make
    for daemon, server, client in made:
        client.close()
        server.close()
        daemon.stop()


@pytest.mark.parametrize("server_pkg", ["torch", "jax"])
@pytest.mark.parametrize(
    "codec,pipeline_depth,submit_buffer",
    [("raw", 1, 1), ("delta", 1, 1), ("qblk", 1, 1), ("raw", 4, 1), ("delta", 1, 3)],
    ids=["raw", "delta", "qblk", "pipelined", "submit_many"],
)
def test_a_client_of_one_package_drives_a_server_of_the_other(
    crossed, server_pkg, codec, pipeline_depth, submit_buffer
):
    daemon, server, client = crossed(
        server_pkg, daemon_kw={}, codec=codec, pipeline_depth=pipeline_depth, submit_buffer=submit_buffer
    )
    # the client found no local server of its own package: it speaks TCP
    own_wire = jwire if server_pkg == "torch" else twire
    assert own_wire.local_server(server.endpoint) is None
    ack = client.attach("t", SPEC)
    assert ack["codec"] == codec
    batches = _batches(seed=1)
    for s, l in batches[:3]:
        assert client.submit("t", s, l)
    if daemon._evict_dir_arg is not None:
        client.flush("t")
    for s, l in batches[3:]:
        assert client.submit("t", s, l)
    got = {k: np.asarray(v) for k, v in client.compute("t").items()}
    want = _direct(server_pkg, _dequantized(batches) if codec == "qblk" else batches)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    health = client.health()["tenants"]["t"]
    assert (health["processed"], health["dupes"]) == (6, 0)
    assert client.detach("t") is None


@pytest.mark.parametrize("server_pkg", ["torch", "jax"])
def test_flush_and_resume_watermarks_cross(crossed, server_pkg, tmp_path):
    _, _, client = crossed(server_pkg, daemon_kw={"evict_dir": str(tmp_path)})
    client.attach("t", SPEC)
    batches = _batches(seed=2)
    for s, l in batches[:4]:
        client.submit("t", s, l)
    out = client.flush("t")
    assert out["acked_seq"] == 4
    assert len(client._tenant_state("t").replay) == 0
    for s, l in batches[4:]:
        client.submit("t", s, l)
    got = client.compute("t")
    want = _direct(server_pkg, batches)
    assert np.asarray(got["acc"]).tobytes() == want["acc"].tobytes()


def _live_errors(pkg, tmp_path):
    """Drive a server of ``pkg`` with a client of the other package into
    each serve failure; returns ``{case: exception}`` as the client saw it."""
    daemon = _daemon(pkg, evict_dir=str(tmp_path)).start()
    server = PKGS[pkg].EvalServer(daemon)
    client = PKGS[OTHER[pkg]].EvalClient(server.endpoint, max_attempts=1, request_timeout_s=60.0)
    out = {}

    def catch(name, fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - collected
            out[name] = e

    try:
        client.attach("t", SPEC)
        catch("duplicate", lambda: client.attach("t", SPEC))
        catch("unknown_tenant", lambda: client.compute("ghost"))
        catch("protocol", lambda: client._call("frobnicate", {}))
        catch("value", lambda: client.attach("v", SPEC, step_timeout_s=-1.0))
        catch("bad_metrics", lambda: client.attach("b", {"m": ["NotAMetric", {}]}))
        client.attach("q", SPEC, queue_capacity=1)
        daemon._tenants["q"].capacity = 0
        catch("queue_full", lambda: client.submit("q", *_batches(1)[0]))
        client.attach("p", SPEC)
        s, l = _batches(1)[0]
        client.submit("p", s, l[:-1])
        catch("poisoned", lambda: client.compute("p"))
        client.attach("e", SPEC)
        client.submit("e", s, l)
        daemon.evict("e", timeout=60)
        catch("evicted", lambda: client.compute("e"))
    finally:
        client.close()
        server.close()
        daemon.stop()
    return out


@pytest.mark.parametrize("server_pkg", ["torch", "jax"])
def test_live_errors_cross_with_class_reason_and_retryable(server_pkg, tmp_path):
    client_pkg = PKGS[OTHER[server_pkg]]
    got = _live_errors(server_pkg, tmp_path)
    expect = {
        "duplicate": (client_pkg.AdmissionError, "duplicate_tenant", False),
        "unknown_tenant": (client_pkg.ServeError, "unknown_tenant", False),
        "protocol": (client_pkg.WireError, "protocol", False),
        "bad_metrics": (client_pkg.AdmissionError, "bad_metrics", False),
        "queue_full": (client_pkg.BackpressureError, "queue_full", True),
        "poisoned": (client_pkg.TenantQuarantinedError, "poisoned_batch", False),
        "evicted": (client_pkg.TenantEvictedError, "evicted", False),
    }
    for case, (cls, reason, retryable) in expect.items():
        exc = got[case]
        assert type(exc) is cls, (case, exc)
        assert (exc.reason, exc.retryable) == (reason, retryable), case
    assert isinstance(got["value"], ValueError)
    assert got["evicted"].checkpoint and got["poisoned"].tenant == "p"


def _every_error(S, ckpt_error):
    return [
        S.BackpressureError("queue_full", "full", tenant="bob"),
        S.AdmissionError("capacity", "at max"),
        S.AdmissionError("draining", "no"),
        S.TenantQuarantinedError("nan_policy", "poisoned", tenant="bob"),
        S.TenantEvictedError("watchdog_idle", "gone", tenant="carol", checkpoint="/c/k"),
        S.TenantError("weird", "odd", tenant="t"),
        S.WireError("transport", "net", endpoint="h:1"),
        S.WireError("protocol", "skew"),
        S.ServeError("unknown_tenant", "nope"),
        ckpt_error("schema_mismatch", "drift"),
        ValueError("timeout_s must be positive"),
    ]


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_every_error_class_decodes_in_the_other_package(direction):
    if direction == "torch_to_jax":
        errors, encode, decode, dst = _every_error(ts, TCheckpointError), twire.encode_error, jwire.decode_error, js
        dst_ckpt = JCheckpointError
    else:
        errors, encode, decode, dst = _every_error(js, JCheckpointError), jwire.encode_error, twire.decode_error, ts
        dst_ckpt = TCheckpointError
    for exc in errors:
        wire = encode(exc)
        got = decode(wire)
        name = type(exc).__name__
        want_cls = dst_ckpt if name == "CheckpointError" else getattr(dst, name, ValueError)
        assert type(got) is want_cls, name
        assert str(got) == str(exc) or name == "ValueError", name
        assert bool(getattr(got, "retryable", False)) == bool(getattr(exc, "retryable", False)), name
        for field in ("reason", "tenant", "checkpoint", "endpoint"):
            assert getattr(got, field, None) == getattr(exc, field, None), (name, field)


@pytest.mark.parametrize("codec", ["raw", "delta", "qblk"])
@pytest.mark.parametrize("packer", ["torch", "jax"])
def test_frames_decode_in_the_other_package(codec, packer):
    rng = np.random.default_rng(7)
    tree = {
        "args": [rng.random((256, C)).astype(np.float32), rng.integers(0, C, 256)],
        "ids": np.cumsum(rng.integers(0, 5, 200)),
        "meta": {"n": 3, "x": None},
    }
    pack, unpack = (twire, jwire) if packer == "torch" else (jwire, twire)
    spec, blob = pack.pack_tree(tree, codec=codec)
    via_other = unpack.unpack_tree(spec, blob)
    via_self = pack.unpack_tree(spec, blob)
    spec_p, parts, total = pack.pack_tree_parts(tree, codec=codec)
    assembled = b"".join(bytes(memoryview(p).cast("B")) for p in parts)
    assert len(assembled) == total
    via_parts = unpack.unpack_tree(spec_p, assembled)
    for got in (via_other, via_parts):
        np.testing.assert_array_equal(got["args"][0], via_self["args"][0])
        np.testing.assert_array_equal(got["args"][1], tree["args"][1])
        np.testing.assert_array_equal(got["ids"], tree["ids"])
        assert got["meta"] == tree["meta"]


@pytest.mark.parametrize("first,second", [("torch", "jax"), ("jax", "torch")])
def test_an_evicted_tenant_resumes_in_the_other_packages_daemon(tmp_path, first, second):
    batches = _batches(seed=3)

    def members(pkg):
        if pkg == "torch":
            return {"acc": tm.MulticlassAccuracy(num_classes=C, device="cpu"),
                    "f1": tm.MulticlassF1Score(num_classes=C, average="macro", device="cpu")}  # fmt: skip
        return {"acc": jm.MulticlassAccuracy(num_classes=C), "f1": jm.MulticlassF1Score(num_classes=C, average="macro")}

    with _daemon(first, evict_dir=str(tmp_path)) as d1:
        h = d1.attach("mover", members(first))
        for s, l in batches[:3]:
            h.submit(s, l)
        path = d1.evict("mover", timeout=60)
    with _daemon(second, evict_dir=str(tmp_path)) as d2:
        h2 = d2.attach("mover", members(second), resume="require")
        for s, l in batches[3:]:
            h2.submit(s, l)
        got = {k: np.asarray(v) for k, v in h2.compute(timeout=60).items()}
    assert path
    want = _direct(second, batches)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-8)


# --- mixed fleets behind a router -------------------------------------------

ROUTER_KW = dict(request_timeout_s=60.0, connect_timeout_s=5.0, max_attempts=2, backoff_base_s=0.01)


def _router(pkg, endpoints):
    if pkg == "torch":
        return ts.EvalRouter(endpoints, device="cpu", local_transport=False, **ROUTER_KW)
    return js.EvalRouter(endpoints, local_transport=False, **ROUTER_KW)


@pytest.mark.parametrize("how", ["drain", "kill"])
@pytest.mark.parametrize(
    "router_pkg,src_pkg", [("torch", "jax"), ("jax", "torch"), ("torch", "torch"), ("jax", "jax")]
)
def test_a_router_migrates_a_tenant_across_the_packages(tmp_path, router_pkg, src_pkg, how):
    """The source host's package writes the checkpoint and the other
    package's host restores it (``resume="auto"``). A drain checkpoints
    the whole stream so far (seq 4); a killed host leaves the flushed seq
    3, and the router replays batch 4 and the submit that found the death."""
    root = str(tmp_path / "ckpt")
    hosts = []
    for pkg in (src_pkg, OTHER[src_pkg]):
        daemon = _daemon(pkg, evict_dir=root).start()
        hosts.append((daemon, PKGS[pkg].EvalServer(daemon)))
    (src_daemon, src), (dst_daemon, dst) = hosts
    router = _router(router_pkg, [src.endpoint, dst.endpoint])
    try:
        tid = next(f"t{i}" for i in range(256) if router._place(f"t{i}") == src.endpoint)
        assert router.attach(tid, SPEC) == src.endpoint
        batches = _batches(n=6, seed=21)
        for b in batches[:3]:
            router.submit(tid, *b)
        router.flush(tid)  # durable on the source's package
        router.submit(tid, *batches[3])
        if how == "drain":
            assert router.drain(src.endpoint)["migrated"] == [tid]
        else:
            src.close()
            src_daemon.stop()
        for b in batches[4:]:
            router.submit(tid, *b)
        assert router.placement()[tid] == dst.endpoint
        got = {k: np.asarray(v) for k, v in router.compute(tid).items()}
        want = _direct(OTHER[src_pkg], batches)
        np.testing.assert_array_equal(got["acc"], want["acc"])
        np.testing.assert_allclose(got["f1"], want["f1"], rtol=1e-5, atol=0)
        health = dst_daemon.health()["tenants"][tid]
        assert health["dupes"] == 0
        assert health["processed"] == (2 if how == "drain" else 3)
    finally:
        router.close()
        for daemon, server in hosts:
            server.close()
            daemon.stop()
