"""Network wire for the eval service: framing, marshalling, `EvalServer`.

JAX counterpart: ``torcheval_tpu/serve/wire.py``, byte-compatible with it:
a client of either package drives a server of the other over TCP (each
package keeps its own same-process registry, so the local transport never
crosses packages). The framing is stdlib and numpy; what differs is the
device. :func:`build_metrics` builds a spec's metrics from
``torcheval_tpu_torch.metrics`` on the server's device, the server's
staging pool is pinned for its daemon's CUDA device, and a result's
tensors (on the card) are read back to numpy to be marshalled.

The ingestion layer. The single-host :class:`EvalDaemon`
already decouples many producer *threads* from one device-owning worker;
this module pushes the producer side across a network boundary — the
Podracer split of many remote actors feeding a small number of
device-owning learners (arXiv:2104.06272) — with **no new runtime
dependency**: plain TCP sockets, a length-prefixed JSON header, and an
optional ``npz`` binary payload for arrays.

Frame layout (all integers big-endian)::

    magic   4 bytes  b"TEW1"   (protocol + version; a stray speaker on
                                the port fails fast as "protocol")
    hlen    4 bytes  uint32    header length
    plen    8 bytes  uint64    payload length
    header  hlen bytes         UTF-8 JSON object
    payload plen bytes         npz archive (absent when plen == 0)

Request headers carry ``op`` (``attach`` / ``submit`` / ``compute`` /
``sync_compute`` / ``flush`` / ``detach`` / ``drain`` / ``health`` /
``snapshot`` / ``subscribe_obs``) plus op-specific fields; responses
carry ``ok`` and either
the result or a structured ``error`` object that reconstructs the
serve-side exception CLASS, ``reason``, and ``retryable`` flag on the
client (:func:`encode_error` / :func:`decode_error`) — a remote caller
branches on exactly the bits a local caller would.

Array trees (submit args, compute results) cross as
:func:`pack_tree`/:func:`unpack_tree`: a JSON spec mirroring the
container structure with array leaves swapped for indices into one npz
payload — exact dtype/shape round trip, no pickling, ``allow_pickle``
stays off.

**Exactly-once submits.** Each wire submit carries the client's
per-tenant monotonic ``seq``; the daemon deduplicates at admission
(``seq <= last admitted`` is acknowledged without re-applying). The wire
is therefore at-least-once — a client MAY blindly resend after an
ambiguous failure (connection died after send, before the ack) — while
the metric state is exactly-once. Acks return the tenant's *durable*
watermark (highest seq covered by a published checkpoint) so clients can
prune their bounded replay buffers.

**Obs push channel.** ``subscribe_obs`` flips a connection
from request-response to server-push: after the ``ok`` ack, a
per-subscription :class:`_ObsPublisher` thread owns the socket and ships
``obs_push`` frames on an ``interval_s`` timer — each carrying the
registry's delta-since-cursor (``obs/stream.py``, O(changed) bytes), the
timeline events since the cursor, and the daemon's structured
``load_report()``. Pure TCP: zero collective rounds, ever. A final flush
rides the daemon's ``drain()``/``stop()`` hooks so the last delta
(including the drain's own counters) reaches subscribers before the
socket dies. An OLD server rejects the unknown op structurally
(``WireError("protocol")``) and the subscriber degrades to polling
``health()`` — mixed versions degrade, never break (the negotiation
discipline). Slow subscribers are bounded by the socket send buffer
plus a send timeout: a push that cannot be written in time is dropped
WITH the subscriber (counted in ``obs.stream.dropped``) — a wedged
scraper can never grow daemon-side memory or block a drain.

**Deferred-ack pipelining + local transport.** A client that
negotiated a pipeline window at attach opens a dedicated channel with
``pipeline_open``; the ack flips that connection to deferred-ack service
(:meth:`EvalServer._serve_pipelined`): the connection's reader thread
keeps draining frames into a bounded queue while a writer thread
dispatches them and ships acks as batches commit — up to the granted
``depth`` submit frames ride the wire un-acked, each ack echoing the
frame's ``tenant`` + ``seq``/``seqs`` plus the durable watermark.
Lock-step request-response is unchanged and remains the path for every
non-submit op. Same-process clients skip sockets entirely:
:meth:`EvalServer.local_request` hands the payload across as host
memory (the staging-pool slot IS the buffer the daemon decodes — see
the method doc for the aliasing contract).
"""

from __future__ import annotations

import io
import json
import logging
import socket
import struct
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.obs import registry as _obs
from torcheval_tpu_torch.obs import trace as _trace
from torcheval_tpu_torch.resilience import chaos as _chaos
from torcheval_tpu_torch.serve.errors import (
    AdmissionError,
    ServeError,
    WireError,
)
from torcheval_tpu_torch.utils import quant as _quant
from torcheval_tpu_torch.utils.npz import NPZ_FORMAT_ERRORS, npz_views

_logger = logging.getLogger(__name__)

__all__ = [
    "EvalServer",
    "WIRE_CODECS",
    "pack_tree",
    "pack_tree_parts",
    "unpack_tree",
    "encode_error",
    "decode_error",
    "send_frame",
    "send_frame_parts",
    "recv_frame",
    "recv_frame_into",
]

# ------------------------------------------------------------- wire codecs
# Negotiated payload codecs. The raw wire ships every array
# leaf verbatim inside the npz payload; a negotiated codec re-encodes
# leaves at pack time, with the decode recipe carried IN THE TREE SPEC —
# so the receiver needs no per-connection state and a frame is always
# self-describing:
#
#   "delta"  delta + min-offset narrowed integer leaves (LOSSLESS —
#            results stay bit-identical; int64 label streams narrow ~8x)
#   "qblk"   everything "delta" does, plus f32 leaves >= 64 elements
#            block-quantized to int8 with per-block f32 scales (bounded
#            error: each element within max|block|/254 — utils/quant.py).
#            An explicit opt-in: score batches decode to *dequantized*
#            values, so downstream metric values carry the documented
#            drift
#
# Negotiation is a capability exchange at ``attach``: the client offers
# ``codecs=[...]`` in the attach header, the server answers with its
# pick, and only then does the client encode — an old server ignores the
# unknown field and answers without one, an old client never offers, and
# either way both sides land on raw with no protocol error (the
# mixed-version interop contract, tested in tests/serve/test_wire_codec.py).
# Every encoder falls back to a raw leaf when encoding would not shrink
# it, so a codec can only reduce payload bytes.
WIRE_CODECS = ("qblk", "delta")

_MAGIC = b"TEW1"
_HEAD = struct.Struct(">4sIQ")
_MAX_HEADER_BYTES = 16 << 20
_MAX_PAYLOAD_BYTES = 1 << 31

# ---------------------------------------------------------- local transport
# Same-process server registry: an EvalServer registers its
# endpoint at bind time so an EvalClient constructed in the SAME process
# can hand request payloads across as host memory (EvalServer.local_request)
# instead of copying them through the loopback socket. Registration is
# keyed by the exact "host:port" endpoint string the client dials, and a
# closed server deregisters — a client that finds nothing here (or races
# a close) simply speaks TCP, byte-identical.
_LOCAL_SERVERS: Dict[str, "EvalServer"] = {}
_LOCAL_SERVERS_LOCK = threading.Lock()


def local_server(endpoint: str) -> Optional["EvalServer"]:
    """The same-process :class:`EvalServer` bound at ``endpoint``, or
    ``None`` — the client's per-request gate for the shared-memory local
    transport."""
    with _LOCAL_SERVERS_LOCK:
        return _LOCAL_SERVERS.get(endpoint)


# ------------------------------------------------------------------ framing
def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes; ``None`` on clean EOF at a frame
    boundary (``n`` asked, zero read); ``protocol`` error mid-frame."""
    if n == 0:
        return b""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            if not buf:
                return None
            raise WireError(
                "protocol",
                f"connection closed mid-frame ({len(buf)}/{n} bytes).",
            )
        buf += chunk
    return bytes(buf)


def send_frame(
    sock: socket.socket, header: Dict[str, Any], payload: bytes = b""
) -> None:
    """Serialize and send one frame (header dict + binary payload).
    Scatter-gather (``sendmsg``) where the platform has it: composing
    ``head + header + payload`` into one bytes object re-copies the whole
    payload per frame — at config8's 32 MB batches that copy was a
    measurable slice of the wire gap."""
    hbytes = json.dumps(header, separators=(",", ":")).encode()
    head = _HEAD.pack(_MAGIC, len(hbytes), len(payload))
    if payload and hasattr(sock, "sendmsg"):
        _send_parts(sock, [head, hbytes, payload])
        return
    sock.sendall(head + hbytes + payload)


# segments per sendmsg call: Linux IOV_MAX is 1024 and sendmsg raises
# EMSGSIZE above it — chunk conservatively below the limit
_IOV_CHUNK = 1000


def _send_parts(sock: socket.socket, parts: List[Any]) -> None:
    # flat byte views only: short-write resumption below counts BYTES, and
    # a shaped (e.g. float32) memoryview's len()/slicing count elements
    parts = [
        p
        if isinstance(p, (bytes, bytearray))
        else memoryview(p).cast("B")
        for p in parts
    ]
    for start in range(0, len(parts), _IOV_CHUNK):
        chunk = parts[start : start + _IOV_CHUNK]
        sent = sock.sendmsg(chunk)
        for p in chunk:  # finish any short scatter write part by part
            if sent >= len(p):
                sent -= len(p)
                continue
            sock.sendall(p[sent:] if sent else p)
            sent = 0


def send_frame_parts(
    sock: socket.socket,
    header: Dict[str, Any],
    parts: List[Any],
    total: int,
) -> None:
    """:func:`send_frame` whose payload is a scatter-gather parts list
    (:func:`pack_tree_parts`): the payload bytes go from their owning
    buffers straight into the kernel — never assembled in user space."""
    hbytes = json.dumps(header, separators=(",", ":")).encode()
    head = _HEAD.pack(_MAGIC, len(hbytes), total)
    if hasattr(sock, "sendmsg"):
        _send_parts(sock, [head, hbytes, *parts])
        return
    sock.sendall(b"".join([head, hbytes, *map(bytes, parts)]))


def _recv_prefix(
    sock: socket.socket,
) -> Optional[Tuple[Dict[str, Any], int]]:
    """Read and validate one frame's prefix (magic, sizes, JSON header);
    returns ``(header, payload_len)``, or ``None`` on clean EOF at a
    frame boundary. The ONE copy of the frame-prefix protocol shared by
    :func:`recv_frame` and :func:`recv_frame_into`."""
    head = _recv_exact(sock, _HEAD.size)
    if head is None:
        return None
    magic, hlen, plen = _HEAD.unpack(head)
    if magic != _MAGIC:
        raise WireError(
            "protocol",
            f"bad frame magic {magic!r} (expected {_MAGIC!r}) — not a "
            "torcheval-tpu eval-wire peer, or a protocol version skew.",
        )
    if hlen > _MAX_HEADER_BYTES or plen > _MAX_PAYLOAD_BYTES:
        raise WireError(
            "protocol", f"frame sizes out of range (hlen={hlen}, plen={plen})."
        )
    hbytes = _recv_exact(sock, hlen)
    if hbytes is None:
        raise WireError("protocol", "connection closed before header.")
    try:
        header = json.loads(hbytes)
    except json.JSONDecodeError as e:
        raise WireError("protocol", f"unparseable frame header: {e}") from None
    return header, plen


def recv_frame(
    sock: socket.socket,
) -> Optional[Tuple[Dict[str, Any], bytes]]:
    """Receive one frame; ``None`` on clean EOF. Raises
    :class:`WireError(reason="protocol")` on garbage — wrong magic,
    absurd lengths, unparseable header — so a client never retries
    against a peer that speaks something else."""
    prefix = _recv_prefix(sock)
    if prefix is None:
        return None
    header, plen = prefix
    payload = _recv_exact(sock, plen)
    if payload is None and plen:
        raise WireError("protocol", "connection closed before payload.")
    return header, payload or b""


def _recv_exact_into(sock: socket.socket, mv: memoryview) -> None:
    """Fill ``mv`` completely from the socket; ``protocol`` error on EOF
    mid-payload (the caller has already read this frame's header)."""
    want = len(mv)
    got = 0
    while got < want:
        n = sock.recv_into(mv[got:], min(want - got, 1 << 20))
        if not n:
            raise WireError(
                "protocol",
                f"connection closed mid-frame ({got}/{want} bytes).",
            )
        got += n


def recv_frame_into(
    sock: socket.socket, pool: Any
) -> Optional[Tuple[Dict[str, Any], Any, Any]]:
    """:func:`recv_frame`, but the payload lands in a pooled staging
    buffer instead of a fresh ``bytes`` object: returns ``(header,
    payload_view, stage)`` where ``stage`` is the
    :class:`~torcheval_tpu_torch.serve.ingest.PooledBuffer` backing
    ``payload_view`` (``None`` for payloadless frames — then
    ``payload_view`` is ``b""``). The caller owns releasing the stage.
    The pooled fill is the timeline's ``serve.ingest.stage`` bar: the
    window in which this frame's bytes were landing in host memory."""
    prefix = _recv_prefix(sock)
    if prefix is None:
        return None
    header, plen = prefix
    if not plen:
        return header, b"", None
    t0 = time.perf_counter()
    stage = pool.acquire(plen)
    view = stage.view(plen)
    try:
        _recv_exact_into(sock, view)
    except BaseException:
        stage.release()
        raise
    if _obs._enabled:
        _trace.complete(
            "serve.ingest.stage",
            t0,
            time.perf_counter() - t0,
            kind="serve",
            bytes=plen,
        )
    return header, view, stage


# -------------------------------------------------------------- tree coding
def _encode_leaf(
    arr: np.ndarray, arrays: Dict[str, np.ndarray], codec: str
) -> Optional[Dict[str, Any]]:
    """Try the negotiated codec on one array leaf; register the encoded
    member(s) into ``arrays`` and return the self-describing spec node,
    or ``None`` when the leaf should ship raw (no win / wrong dtype /
    non-finite floats — the per-leaf raw fallback)."""
    if arr.dtype.kind in "iu":
        parts = _quant.delta_int_parts(arr)
        if parts is None:
            return None
        offset, data = parts
        key = f"a{len(arrays)}"
        arrays[key] = data
        return {
            "t": "darr",
            "i": key,
            "d": arr.dtype.str,
            "sh": list(arr.shape),
            "o": offset,
        }
    if codec == "qblk" and arr.dtype == np.float32:
        parts = _quant.q8_parts(arr)
        if parts is None:
            return None
        scales, q = parts
        key = f"a{len(arrays)}"
        skey = f"a{len(arrays) + 1}"
        arrays[key] = q
        arrays[skey] = scales
        return {"t": "qarr", "i": key, "s": skey, "sh": list(arr.shape)}
    return None


def _tree_encoder(arrays: Dict[str, np.ndarray], codec: str = "raw"):
    """The shared spec encoder behind :func:`pack_tree` and
    :func:`pack_tree_parts`: array leaves register into ``arrays``,
    re-encoded per the negotiated ``codec`` where that shrinks them."""

    def enc(x: Any) -> Any:
        if x is None or isinstance(x, (bool, int, float, str)):
            return {"t": "py", "v": x}
        if isinstance(x, dict):
            return {
                "t": "dict",
                "k": [enc(k) for k in x.keys()],
                "v": [enc(v) for v in x.values()],
            }
        if isinstance(x, (list, tuple)):
            return {
                "t": "list" if isinstance(x, list) else "tuple",
                "v": [enc(v) for v in x],
            }
        if isinstance(x, torch.Tensor):
            # a result on the card is read back once, here
            x = x.detach().cpu()
        try:
            arr = np.asarray(x)
        except Exception:
            arr = None
        if arr is None or arr.dtype == object:
            # np.asarray swallows almost anything into an object array;
            # an object leaf would need pickling, which the wire refuses
            raise WireError(
                "protocol",
                f"cannot marshal {type(x).__name__} over the eval wire "
                "(dicts, lists, scalars and numeric array-likes only).",
            )
        if codec != "raw":
            node = _encode_leaf(arr, arrays, codec)
            if node is not None:
                return node
        key = f"a{len(arrays)}"
        arrays[key] = arr
        return {"t": "arr", "i": key}

    return enc


def pack_tree(obj: Any, codec: str = "raw") -> Tuple[Any, bytes]:
    """Encode a result/args tree (dicts, lists/tuples, scalars, arrays)
    into a JSON-safe spec plus ONE npz payload holding every array leaf.
    Anything with ``__array__`` (numpy arrays, torch tensors on any
    device) becomes an array leaf; exact dtype/shape survive the round trip.
    ``codec`` engages the negotiated leaf re-encoders (:data:`WIRE_CODECS`
    block comment) — only send it after the peer advertised support."""
    arrays: Dict[str, np.ndarray] = {}
    spec = _tree_encoder(arrays, codec)(obj)
    if not arrays:
        return spec, b""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return spec, buf.getvalue()


# zip structure constants for the scatter-gather packer
_ZIP_LOCAL = struct.Struct("<4s5H3I2H")
_ZIP_CENTRAL = struct.Struct("<4s6H3I5H2I")
_ZIP_EOCD = struct.Struct("<4s4H2IH")


def pack_tree_parts(
    obj: Any, codec: str = "raw"
) -> Tuple[Any, List[Any], int]:
    """:func:`pack_tree` for the ingest hot path: returns ``(spec, parts,
    total_len)`` where ``parts`` is a scatter-gather list whose array-data
    members are MEMORYVIEWS of the caller's own buffers — the payload is
    never assembled, ``send_frame`` hands the parts straight to
    ``sendmsg``. The archive is a STORED npz whose members' data offsets
    are 64-byte aligned (so the receiving :func:`unpack_tree` decodes
    zero-copy views), with one deliberate deviation: **member CRC32
    fields are zero**. Computing real CRCs costs one full pass over the
    payload per frame — the exact per-byte work this path exists to
    remove — and the repo's own decoder (``utils/npz.py``) never reads
    them. Foreign ``np.load`` consumers must use :func:`pack_tree`
    (checkpoints do: ``resilience.save`` keeps real npz + sha256).

    The caller must keep the encoded arrays alive until the send
    completes (the parts alias their buffers). ``codec`` as in
    :func:`pack_tree` (codec-encoded members are freshly-allocated
    narrow arrays, kept alive by the returned parts list itself)."""
    arrays: Dict[str, np.ndarray] = {}
    spec = _tree_encoder(arrays, codec)(obj)
    if not arrays:
        return spec, [], 0
    parts: List[Any] = []
    central = []
    offset = 0
    import zlib

    for key, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        name = f"{key}.npy".encode()
        dtype_descr = np.lib.format.dtype_to_descr(arr.dtype)
        header = (
            "{'descr': %r, 'fortran_order': False, 'shape': %r, }"
            % (dtype_descr, arr.shape)
        ).encode("latin1")
        # absolute 64-byte data alignment: pad the npy header (spaces
        # before the terminating newline, per the npy spec) so
        # data_start = offset + 30 + len(name) + 10 + hlen is 0 mod 64
        base_hlen = len(header) + 1
        data_start = offset + 30 + len(name) + 10 + base_hlen
        hlen = base_hlen + (-data_start) % 64
        npy_head = (
            b"\x93NUMPY\x01\x00"
            + struct.pack("<H", hlen)
            + header
            + b" " * (hlen - base_hlen)
            + b"\n"
        )
        size = len(npy_head) + arr.nbytes
        crc = 0
        if not isinstance(dtype_descr, str):
            # structured dtypes take the receiver's CHECKED copy fallback
            # (zipfile verifies member CRCs at EOF there), so they alone
            # pay the real checksum; plain-descr members ride the
            # CRC-blind zero-copy path (module doc above)
            crc = zlib.crc32(
                arr.data.cast("B"), zlib.crc32(npy_head)
            )
        local = _ZIP_LOCAL.pack(
            b"PK\x03\x04", 20, 0, 0, 0, 0, crc, size, size, len(name), 0
        )
        parts.append(local + name + npy_head)
        if arr.nbytes:
            # flat byte view: scatter-send bookkeeping counts bytes
            parts.append(arr.data.cast("B"))
        central.append((name, offset, size, crc))
        offset += 30 + len(name) + size
    cd_start = offset
    cd = bytearray()
    for name, off, size, crc in central:
        cd += _ZIP_CENTRAL.pack(
            b"PK\x01\x02", 20, 20, 0, 0, 0, 0, crc, size, size,
            len(name), 0, 0, 0, 0, 0, off,
        )
        cd += name
    cd += _ZIP_EOCD.pack(
        b"PK\x05\x06", 0, 0, len(central), len(central), len(cd), cd_start, 0
    )
    parts.append(bytes(cd))
    return spec, parts, cd_start + len(cd)


def unpack_tree(spec: Any, payload: Any) -> Any:
    """Inverse of :func:`pack_tree`. ``payload`` may be ``bytes`` or any
    buffer (a pooled staging view): aligned uncompressed leaves decode as
    zero-copy ``np.frombuffer`` views over the payload itself — no
    per-leaf heap allocation on the steady path — with a per-leaf copy
    fallback for compressed/misaligned/structured members
    (``utils/npz.py``; object arrays still reject exactly like
    ``allow_pickle=False``). The views pin the payload buffer (via
    ``ndarray.base``) for as long as any leaf lives, and are READ-ONLY
    when the payload is (a ``bytes`` frame) — callers that mutate a
    decoded result in place must copy it first (``np.load`` used to hand
    back fresh writable arrays here).

    Codec-encoded leaves (``darr``/``qarr`` nodes from a negotiated
    wire codec) are self-describing — the spec carries the decode
    recipe, so no codec argument is needed here. Their decode
    necessarily allocates (a cumsum / a dequantization), but the
    *encoded* members still stage zero-copy through the pool and the
    decoded array keeps the original (shape, dtype) signature, so the
    daemon's one-H2D-per-signature-group coalescing is unaffected."""
    arrays: Dict[str, np.ndarray] = {}
    if len(payload):
        try:
            arrays = npz_views(payload)
        except NPZ_FORMAT_ERRORS as e:
            raise WireError(
                "protocol", f"undecodable array payload: {e}"
            ) from None

    def dec(s: Any) -> Any:
        try:
            t = s["t"]
            if t == "py":
                return s["v"]
            if t == "dict":
                return {
                    dec(k): dec(v) for k, v in zip(s["k"], s["v"])
                }
            if t == "list":
                return [dec(v) for v in s["v"]]
            if t == "tuple":
                return tuple(dec(v) for v in s["v"])
            if t == "arr":
                return arrays[s["i"]]
            if t == "darr":
                return _quant.delta_int_from_parts(
                    arrays[s["i"]],
                    int(s["o"]),
                    np.dtype(s["d"]),
                    tuple(s["sh"]),
                )
            if t == "qarr":
                return _quant.q8_from_parts(
                    arrays[s["s"]], arrays[s["i"]], tuple(s["sh"])
                )
        except (KeyError, TypeError, IndexError, ValueError):
            # ValueError covers codec-node decode failures (a spec shape
            # that disagrees with the member's element count, a bad dtype
            # string): same malformed-frame classification as the rest
            pass
        raise WireError("protocol", f"malformed tree spec node: {s!r}.")

    return dec(spec)


# ------------------------------------------------------------------- errors
def _bare_message(exc: BaseException) -> str:
    """Strip the ``[reason]`` prefix ``ServeError.__init__`` composes, so
    a decode does not stack a second one."""
    msg = str(exc)
    reason = getattr(exc, "reason", None)
    prefix = f"[{reason}] "
    return msg[len(prefix):] if reason and msg.startswith(prefix) else msg


def encode_error(exc: BaseException) -> Dict[str, Any]:
    """Structured wire form of a serve-side failure: class name, reason,
    retryable flag, and the per-class extras (tenant/checkpoint)."""
    out: Dict[str, Any] = {
        "type": type(exc).__name__,
        "reason": getattr(exc, "reason", "internal"),
        "message": _bare_message(exc),
        "retryable": bool(getattr(exc, "retryable", False)),
    }
    for field in ("tenant", "checkpoint", "endpoint"):
        value = getattr(exc, field, None)
        if value is not None:
            out[field] = value
    return out


def decode_error(err: Dict[str, Any]) -> BaseException:
    """Reconstruct the exception :func:`encode_error` marshalled: the
    matching serve class when the type is known (so an except-clause
    written against local daemon calls works unchanged against the
    wire), a generic :class:`ServeError` otherwise. ``retryable`` is
    copied from the wire — the shared classification crosses intact."""
    from torcheval_tpu_torch.resilience.snapshot import CheckpointError
    from torcheval_tpu_torch.serve import errors as _errs

    name = err.get("type", "ServeError")
    reason = err.get("reason", "internal")
    message = err.get("message", "(no message)")
    tenant = err.get("tenant", "?")
    exc: BaseException
    if name == "BackpressureError":
        exc = _errs.BackpressureError(reason, message, tenant=tenant)
    elif name == "TenantQuarantinedError":
        exc = _errs.TenantQuarantinedError(reason, message, tenant=tenant)
    elif name == "TenantEvictedError":
        exc = _errs.TenantEvictedError(
            reason, message, tenant=tenant, checkpoint=err.get("checkpoint")
        )
    elif name == "TenantError":
        exc = _errs.TenantError(reason, message, tenant=tenant)
    elif name == "AdmissionError":
        exc = _errs.AdmissionError(reason, message)
    elif name == "WireError":
        exc = _errs.WireError(reason, message, endpoint=err.get("endpoint"))
    elif name == "CheckpointError":
        exc = CheckpointError(reason, message)
    elif name == "ValueError":
        exc = ValueError(message)
    else:
        exc = _errs.ServeError(reason, message)
    if hasattr(exc, "retryable") or "retryable" in err:
        exc.retryable = bool(err.get("retryable", False))
    return exc


# ------------------------------------------------------------- metric specs
def build_metrics(spec: Dict[str, Any], *, device: Any = None) -> Dict[str, Any]:
    """Instantiate ``{name: Metric}`` from a wire metric spec
    ``{name: [class_name, kwargs]}`` — class names resolve against the
    public ``torcheval_tpu_torch.metrics`` namespace only (no dotted paths, no
    pickles: a metric spec can never execute caller-chosen code), which
    exports the same names as the JAX package's, so a spec means the same
    to both. Every metric is built on ``device`` (``None`` = ``cuda:0``,
    which raises without CUDA): the device is the server's, and a spec
    that names one is refused. An unknown class or bad constructor args
    reject as ``AdmissionError("bad_metrics")``."""
    from torcheval_tpu_torch import metrics as _metrics_ns
    from torcheval_tpu_torch.metrics.metric import Metric
    from torcheval_tpu_torch.utils.devices import canonical_device

    device = canonical_device(device)

    if not isinstance(spec, dict) or not spec:
        raise AdmissionError(
            "bad_metrics", f"metric spec must be a non-empty dict, got {spec!r}."
        )
    out: Dict[str, Any] = {}
    for name, entry in spec.items():
        try:
            cls_name, kwargs = entry[0], (entry[1] if len(entry) > 1 else {})
        except (TypeError, IndexError, KeyError):
            raise AdmissionError(
                "bad_metrics",
                f"metric spec entry {name!r} must be [class_name, kwargs], "
                f"got {entry!r}.",
            ) from None
        cls = getattr(_metrics_ns, str(cls_name), None)
        if not (isinstance(cls, type) and issubclass(cls, Metric)):
            raise AdmissionError(
                "bad_metrics",
                f"metric spec entry {name!r} names {cls_name!r}, which is "
                "not a torcheval_tpu_torch.metrics Metric class.",
            )
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            raise AdmissionError(
                "bad_metrics",
                f"metric spec entry {name!r} names a device; the server "
                "builds every metric on its own.",
            )
        try:
            out[name] = cls(**kwargs, device=device)
        except (TypeError, ValueError) as e:
            raise AdmissionError(
                "bad_metrics",
                f"constructing {cls_name}({kwargs!r}) for {name!r} failed: {e}",
            ) from e
    return out


# -------------------------------------------------------------- obs push
class _ObsPublisher:
    """One obs-push subscription: a thread that owns a handed-over
    connection and ships ``obs_push`` frames on a timer (see module doc).

    Timer discipline: fixed-rate scheduling against ``monotonic`` — a
    push that takes longer than ``interval_s`` (slow subscriber, giant
    delta) does not accumulate debt; the skipped ticks are counted into
    ``obs.stream.dropped`` (no telemetry is lost — the next delta folds
    everything since the cursor — but the *cadence* contract was missed
    and the subscriber deserves to know). The send carries a timeout: a
    peer that stops reading long enough to fill its socket buffer AND
    outlast the timeout is dropped entirely (a partial frame write is
    unrecoverable framing-wise), which bounds daemon-side cost at one
    in-flight frame per subscriber."""

    def __init__(
        self,
        server: "EvalServer",
        conn: socket.socket,
        interval_s: float,
    ) -> None:
        self._server = server
        self._conn = conn
        self._interval_s = interval_s
        self._stop = threading.Event()
        self._send_lock = threading.Lock()
        self._cursor = None
        self._push_seq = 0
        self._thread = threading.Thread(
            target=self._run,
            name="torcheval-tpu-obs-publisher",
            daemon=True,
        )

    def start(self) -> None:
        # a wedged subscriber must not block a drain's final flush
        # indefinitely: bound every frame write
        try:
            self._conn.settimeout(max(5.0, 5.0 * self._interval_s))
        except OSError:
            pass
        daemon = self._server._daemon
        add_hook = getattr(daemon, "_add_flush_hook", None)
        if add_hook is not None:
            add_hook(self.flush)
        self._thread.start()

    def _run(self) -> None:
        interval = self._interval_s
        next_t = time.monotonic() + interval
        while not self._stop.is_set():
            timeout = next_t - time.monotonic()
            if timeout > 0 and self._stop.wait(timeout):
                break
            now = time.monotonic()
            missed = -1
            while next_t <= now:
                next_t += interval
                missed += 1
            if missed > 0 and _obs._enabled:
                _obs.counter("obs.stream.dropped", float(missed))
            try:
                from torcheval_tpu_torch.obs import slo as _slo

                _slo.evaluate_slos()
            except Exception:  # noqa: BLE001 - a bad SLO can't kill pushes
                _logger.exception("obs-push: SLO evaluation raised")
            if not self._push():
                break
        self._retire()

    def _push(self) -> bool:
        """Ship one delta; False when the subscriber is gone/wedged."""
        from torcheval_tpu_torch.obs import stream as _stream

        with self._send_lock:
            if self._stop.is_set():
                return False
            delta, cursor = _stream.collect(self._cursor)
            try:
                report = self._server._daemon.load_report()
            except Exception:  # noqa: BLE001 - report trouble != channel
                report = None
            self._push_seq += 1
            header = {
                "op": "obs_push",
                "push_seq": self._push_seq,
                "endpoint": self._server.endpoint,
                "delta": delta,
                "load_report": report,
            }
            try:
                send_frame(self._conn, header)
            except (OSError, ValueError):
                # socket.timeout is an OSError: a subscriber that cannot
                # take one frame within the bounded window is dropped and
                # the drop counted — never buffered against
                if _obs._enabled:
                    _obs.counter("obs.stream.dropped")
                return False
            # only advance the cursor on a successful write: a failed
            # push's changes stay pending (they would fold into the next
            # delta if the subscriber were still there)
            self._cursor = cursor
            if _obs._enabled:
                _obs.counter("obs.stream.pushes")
        return True

    def flush(self) -> None:
        """Synchronous final push (daemon drain()/stop() hook, and
        server.close()): the caller's thread ships the delta so the data
        is on the wire before the socket is severed."""
        if not self._stop.is_set():
            self._push()

    def stop(self) -> None:
        self._stop.set()

    def _retire(self) -> None:
        """Publisher exit path: deregister everywhere and close the
        socket (it was removed from request-response service at
        handover; nothing else will)."""
        daemon = self._server._daemon
        remove_hook = getattr(daemon, "_remove_flush_hook", None)
        if remove_hook is not None:
            remove_hook(self.flush)
        with self._server._lock:
            self._server._conns.discard(self._conn)
            try:
                self._server._publishers.remove(self)
            except ValueError:
                pass
        try:
            self._conn.close()
        except OSError:
            pass


# ------------------------------------------------------------------- server
class EvalServer:
    """TCP front end for one :class:`EvalDaemon`.

    Binds on construction (``port=0`` = OS-assigned, read it back from
    ``.address``) and serves immediately: an accept-loop thread plus one
    handler thread per connection — connection counts at eval-service
    scale are small (routers and producer fleets multiplex many tenants
    per connection), and a blocked tenant op never stalls another
    connection. All device work still happens on the daemon's single
    worker thread; handler threads only enqueue and wait on promises,
    exactly like local producer threads.

    Structured failures cross the wire via :func:`encode_error`; an
    unexpected handler exception is contained per-request (``ok=False``
    with reason ``"internal"``), never tearing the server down.
    """

    def __init__(
        self,
        daemon: Any,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        backlog: int = 32,
        codecs: Tuple[str, ...] = WIRE_CODECS,
        pipeline_depth: int = 32,
    ) -> None:
        from torcheval_tpu_torch.serve.ingest import HostBufferPool

        self._daemon = daemon
        # the daemon's device: specs are built on it, and the staging
        # pool is pinned when it is a CUDA device
        self.device = daemon.device
        # payload codecs this server ACCEPTS (capability exchange at
        # attach; ``codecs=()`` models a raw-only peer — used by the
        # mixed-version interop tests, and a safe rollback knob)
        self._codecs = tuple(codecs)
        # max in-flight submit frames this server grants per pipelined
        # connection. The grant at attach is
        # min(client ask, this); ``pipeline_depth < 2`` never grants and
        # rejects ``pipeline_open`` as an unknown op — exactly how an
        # old server answers, so it doubles as the mixed-version rollback
        # knob (clients silently stay lock-step)
        if not isinstance(pipeline_depth, int) or pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be an int >= 0, got {pipeline_depth!r}."
            )
        self._pipeline_depth = pipeline_depth
        # shared staging pool: frame payloads land here (pinned for a CUDA
        # daemon) and decode as zero-copy views; slots recycle under the
        # ingest aliasing contract (serve/ingest.py)
        self._pool = HostBufferPool(device=self.device)
        self._sock = socket.create_server((host, port), backlog=backlog)
        self.address: Tuple[str, int] = self._sock.getsockname()[:2]
        self._handles: Dict[str, Any] = {}
        self._attach_nonces: Dict[str, Any] = {}
        # attach-time spec + knobs per tenant, served back by the
        # ``list_tenants`` op: a recovering router adopts an
        # orphan — a tenant live here but absent from its journal — only
        # if it can reconstruct the tenant's routing entry, and the spec
        # is not recoverable from the daemon (metrics are already built
        # objects there)
        self._tenant_meta: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._conns: set = set()
        self._publishers: list = []
        self._running = True
        # chaos host_partition: once tripped the server stops ACKing —
        # requests are read and dropped, modelling a half-dead host whose
        # TCP stack answers but whose service never does
        self._partitioned = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop,
            name="torcheval-tpu-eval-server-accept",
            daemon=True,
        )
        self._accept_thread.start()
        # same-process shared-memory transport (module comment at
        # _LOCAL_SERVERS): visible to clients only once fully constructed
        with _LOCAL_SERVERS_LOCK:
            _LOCAL_SERVERS[self.endpoint] = self

    @property
    def endpoint(self) -> str:
        return f"{self.address[0]}:{self.address[1]}"

    def close(self) -> None:
        """Stop accepting AND sever live connections — a closed server is
        fully gone from the network's point of view (clients see dead
        sockets, not a listener that answers on old connections). Obs
        subscribers get a best-effort final push first."""
        self._running = False
        with _LOCAL_SERVERS_LOCK:
            if _LOCAL_SERVERS.get(self.endpoint) is self:
                del _LOCAL_SERVERS[self.endpoint]
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            publishers = list(self._publishers)
        for pub in publishers:
            try:
                pub.flush()
            except Exception:  # noqa: BLE001 - close must proceed
                pass
            pub.stop()
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def __enter__(self) -> "EvalServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ transport
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # closed
            threading.Thread(
                target=self._serve_connection,
                args=(conn,),
                name="torcheval-tpu-eval-server-conn",
                daemon=True,
            ).start()

    def _serve_connection(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        with self._lock:
            self._conns.add(conn)
        handed_over = False
        try:
            while self._running:
                try:
                    frame = recv_frame_into(conn, self._pool)
                except WireError as e:
                    _logger.warning("eval-wire: dropping connection: %s", e)
                    return
                except OSError:
                    # peer reset/closed the socket underneath the read (a
                    # failed health probe tearing down mid-accept): the
                    # connection is simply gone, same as a clean EOF
                    return
                if frame is None:
                    return
                header, payload, stage = frame
                if self._partitioned:
                    if stage is not None:
                        stage.release()
                    continue  # read and never answer (see class doc)
                response = self._dispatch(header, payload, stage)
                if response is None:
                    continue  # partition tripped ON this request
                pub = None
                if response[0].get("ok") and response[0].get("subscribed"):
                    # register the publisher BEFORE acking: the client
                    # treats the ack as "subscribed", so a close() racing
                    # this window must already see the publisher or the
                    # final-flush-on-close guarantee silently lapses
                    pub = _ObsPublisher(
                        self,
                        conn,
                        float(response[0]["interval_s"]),
                    )
                    with self._lock:
                        if not self._running:
                            return  # closing: never ack, just drop
                        self._publishers.append(pub)
                try:
                    send_frame(conn, *response)
                except OSError:
                    if pub is not None:
                        with self._lock:
                            try:
                                self._publishers.remove(pub)
                            except ValueError:
                                pass
                    return
                if pub is not None:
                    # ack sent: the connection now belongs to the
                    # publisher thread (it stays in _conns so close()
                    # severs it; the publisher discards + closes it when
                    # it retires)
                    handed_over = True
                    pub.start()
                    return
                if response[0].get("ok") and response[0].get("pipelined"):
                    # ack sent: the connection switches to deferred-ack
                    # service — this thread keeps reading
                    # frames while a writer thread acks them as they
                    # commit. Returns when the peer goes away; the
                    # finally below closes the socket as usual.
                    self._serve_pipelined(conn, int(response[0]["depth"]))
                    return
        finally:
            if not handed_over:
                with self._lock:
                    self._conns.discard(conn)
                try:
                    conn.close()
                except OSError:
                    pass

    def _serve_pipelined(self, conn: socket.socket, depth: int) -> None:
        """Deferred-ack service for one connection: this
        thread keeps READING frames while a writer thread dispatches
        them and sends acks back as batches commit — frame-receive and
        ack-send are decoupled, so up to ``depth`` frames ride the
        connection at once. The queue bound IS the server-side window:
        a slow dispatcher fills it, the reader stops draining the
        socket, and TCP backpressure holds the client's window — bounded
        memory per connection with no extra protocol machinery. Each ack
        echoes the frame's ``tenant`` and ``seq``/``seqs`` so the client
        matches order-independently; chaos ack actions (ack_delay /
        ack_reorder) inject at the ack write, the exact surface a real
        slow or reordered ack presents."""
        import queue as _queue

        frames: _queue.Queue = _queue.Queue(maxsize=max(1, depth))
        dead = threading.Event()

        def _ack_writer() -> None:
            held: Optional[Tuple[Dict[str, Any], bytes]] = None
            while True:
                item = frames.get()
                if item is None:
                    break
                header, payload, stage = item
                if dead.is_set() or self._partitioned:
                    if stage is not None:
                        stage.release()
                    continue
                # pipelined admission is gapless (EvalDaemon._submit):
                # with several frames of one tenant in flight, a seq
                # admitted past a shed hole would ratchet the dedup
                # watermark over it — tag every frame so the daemon
                # refuses out-of-order admission instead
                header = dict(header)
                header["gapless"] = True
                response = self._dispatch(header, payload, stage)
                if response is None:
                    continue  # partition tripped ON this request
                ack = dict(response[0])
                for key in ("tenant", "seq", "seqs"):
                    if key in header:
                        ack[key] = header[key]
                directive = None
                if _chaos.ack_armed():
                    directive = _chaos.on_host_ack(
                        str(header.get("op", "?")), header.get("tenant")
                    )
                if directive == "ack_delay":
                    time.sleep(_chaos.ack_delay_s())
                try:
                    if directive == "ack_reorder" and held is None:
                        held = (ack, response[1])
                        continue
                    self._write_ack(conn, ack, response[1])
                    if held is not None:
                        (ack, blob), held = held, None
                        self._write_ack(conn, ack, blob)
                except OSError:
                    # peer gone: stop answering, sever the socket so the
                    # reader wakes, and KEEP draining the queue (frames
                    # already read must still release their stages, and
                    # the reader must never block on a full window)
                    dead.set()
                    try:
                        conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
            if held is not None and not dead.is_set():
                try:
                    self._write_ack(conn, *held)
                except OSError:
                    pass

        writer = threading.Thread(
            target=_ack_writer,
            name="torcheval-tpu-eval-server-ack",
            daemon=True,
        )
        writer.start()
        try:
            while self._running and not dead.is_set():
                frame = recv_frame_into(conn, self._pool)
                if frame is None:
                    break
                frames.put(frame)
        except (WireError, OSError):
            pass
        finally:
            frames.put(None)
            writer.join(timeout=5.0)

    def _write_ack(
        self, conn: socket.socket, header: Dict[str, Any], payload: bytes
    ) -> None:
        if _obs._enabled:
            # every ack the deferred writer ships (vs the lock-step
            # request-response path, which never counts here)
            _obs.counter("serve.wire.acks_deferred")
        send_frame(conn, header, payload)

    # ------------------------------------------------------ local transport
    def local_request(
        self, header: Dict[str, Any], payload: Any
    ) -> Tuple[Dict[str, Any], bytes]:
        """Same-process request dispatch (the shared-memory local
        transport): no socket, no frame codec. A ``bytes`` payload
        crosses AS the decode buffer — it is immutable, so the daemon's
        zero-copy npz views alias it safely for as long as they live
        (``stage=None``: nothing to recycle). A scatter-gather
        ``(parts, total)`` payload is assembled once into a staging-pool
        slot — the slot IS the buffer the daemon decodes, replacing the
        socket path's user→kernel→user round trip, and recycles under
        the same anchor-guarded aliasing contract as a socket-landed
        frame. Raises ``OSError`` when the server is closed or
        chaos-partitioned, so the client's transport-retry ladder treats
        a vanished local server exactly like a dead socket (and falls
        back to TCP once the endpoint deregisters)."""
        if not self._running:
            raise OSError("local transport: server is closed")
        total = (
            payload[1] if isinstance(payload, tuple) else len(payload)
        )
        stage: Any = None
        view: Any = b""
        if total:
            t0 = time.perf_counter()
            if not isinstance(payload, tuple):
                view = payload
            else:
                stage = self._pool.acquire(total)
                mv = stage.view(total)
                off = 0
                for part in payload[0]:
                    flat = (
                        part
                        if isinstance(part, (bytes, bytearray))
                        else memoryview(part).cast("B")
                    )
                    mv[off : off + len(flat)] = flat
                    off += len(flat)
                view = mv
            if _obs._enabled:
                # bytes that skipped the socket write+read copy pair
                _obs.counter(
                    "serve.ingest.local_copies_avoided_bytes", float(total)
                )
                _trace.complete(
                    "serve.ingest.stage",
                    t0,
                    time.perf_counter() - t0,
                    kind="serve",
                    bytes=total,
                )
        response = self._dispatch(header, view, stage)
        if response is None:
            raise OSError("local transport: host partitioned")
        return response

    # ------------------------------------------------------------- dispatch
    def _dispatch(
        self, header: Dict[str, Any], payload: Any, stage: Any = None
    ) -> Optional[Tuple[Dict[str, Any], bytes]]:
        op = str(header.get("op", "?"))
        tenant = header.get("tenant")
        if _obs._enabled:
            _obs.counter("serve.wire.requests", op=op)
            if payload is not None and len(payload):
                # received payload bytes per frame codec: with the raw
                # leg's bytes beside the encoded leg's, the wire's
                # compression ratio is readable straight off the registry
                _obs.counter(
                    "serve.wire.rx_bytes",
                    float(len(payload)),
                    codec=str(header.get("codec", "raw")),
                )
        if _chaos.host_armed():
            directive = _chaos.on_host_request(op, tenant)
            if directive == "partition":
                self._partitioned = True
                if stage is not None:
                    stage.release()
                return None
            # "ack_drop" processes below and dies before the ack
        else:
            directive = None
        # single-owner staging discipline: the box holds the stage until
        # the submit path TAKES it (just before handing it to the daemon,
        # which releases on every one of its own paths). The except arm
        # below frees only a stage still in the box — pre-handoff
        # failures (unpack errors, unknown tenants) — so a slot can never
        # be double-released across a pool recycle by two owners.
        stage_box = [stage]
        try:
            out_header, out_payload = self._handle(
                op, header, payload, stage_box
            )
            if stage_box[0] is not None:
                # a payload-bearing non-submit op: nothing took the stage
                stage_box[0].release()
                stage_box[0] = None
            response = ({"ok": True, **out_header}, out_payload)
        except BaseException as exc:  # noqa: BLE001 - containment wall
            if stage_box[0] is not None:
                stage_box[0].release()
            if not isinstance(exc, (ServeError, ValueError)) and not type(
                exc
            ).__name__.endswith("CheckpointError"):
                _logger.exception("eval-wire: %s request failed", op)
            response = ({"ok": False, "error": encode_error(exc)}, b"")
        if directive == "ack_drop":
            # process-then-die-before-ack: the host dies before ANY
            # answer leaves — including an error one; a request that
            # happened to reject must not quietly consume the one-shot
            # fault and let the drill pass without a fault
            _chaos.host_die("ack_drop")
        return response

    def _handle(
        self,
        op: str,
        header: Dict[str, Any],
        payload: Any,
        stage_box: Optional[list] = None,
    ) -> Tuple[Dict[str, Any], bytes]:
        if stage_box is None:
            stage_box = [None]
        if op == "health":
            return {"health": self._daemon.health()}, b""
        if op == "load_report":
            # the rebalancer's cheap pull: the schema-1 load
            # report alone, without the per-tenant health fold a full
            # probe pays. Old peers reject the op as protocol and the
            # client degrades to health()["load_report"].
            return {"load_report": self._daemon.load_report()}, b""
        if op == "list_tenants":
            # the recovering router's reconciliation pull:
            # authoritative per-tenant status + seq watermarks from the
            # daemon, joined with the attach-time spec/knobs this server
            # recorded so orphans are adoptable. Old peers reject the op
            # as protocol and the client degrades to health()["tenants"]
            # (no spec/knobs — orphans on old hosts stay unadopted).
            tenants = self._daemon.list_tenants()
            with self._lock:
                for tid, info in tenants.items():
                    meta = self._tenant_meta.get(tid)
                    if meta is not None:
                        info["spec"] = meta.get("spec")
                        info["knobs"] = meta.get("knobs")
            return {"tenants": tenants}, b""
        if op == "snapshot":
            from torcheval_tpu_torch import obs

            spec, blob = pack_tree(
                {"snapshot": obs.snapshot(), "trace": obs.chrome_trace()}
            )
            return {"result": spec}, blob
        if op == "drain":
            drained = self._daemon.drain(timeout=header.get("timeout"))
            with self._lock:
                for tid in drained:
                    self._handles.pop(tid, None)
                    self._attach_nonces.pop(tid, None)
                    self._tenant_meta.pop(tid, None)
            return {"tenants": drained}, b""
        if op == "attach":
            return self._handle_attach(header)
        if op == "subscribe_obs":
            interval_s = header.get("interval_s", 1.0)
            try:
                interval_s = float(interval_s)
            except (TypeError, ValueError):
                interval_s = float("nan")
            if not (interval_s > 0.0) or interval_s != interval_s:
                raise WireError(
                    "bad_request",
                    f"subscribe_obs interval_s must be a positive number, "
                    f"got {header.get('interval_s')!r}.",
                )
            # the ack doubles as the handover signal: _serve_connection
            # sees "subscribed" in the ok response and hands the socket
            # to a publisher thread instead of reading another request
            return {"subscribed": True, "interval_s": interval_s}, b""
        if op == "pipeline_open":
            if self._pipeline_depth < 2:
                # answer exactly like a server that predates the op: the
                # client swallows the structural reject and stays
                # lock-step (mixed versions degrade, never break) — and
                # pipeline_depth=0 thereby models the old peer in tests
                raise WireError("protocol", f"unknown wire op {op!r}.")
            depth = header.get("depth")
            if not isinstance(depth, int) or isinstance(depth, bool) or (
                depth < 2
            ):
                raise WireError(
                    "bad_request",
                    f"pipeline_open depth must be an int >= 2, got "
                    f"{depth!r}.",
                )
            # the ack doubles as the handover signal, like subscribe_obs:
            # _serve_connection switches this connection to deferred-ack
            # service at the granted window
            return {
                "pipelined": True,
                "depth": min(depth, self._pipeline_depth),
            }, b""
        if op not in (
            "submit",
            "submit_many",
            "compute",
            "sync_compute",
            "flush",
            "detach",
        ):
            raise WireError("protocol", f"unknown wire op {op!r}.")
        # every remaining op targets one attached tenant
        handle = self._tenant_handle(str(header.get("tenant")))
        if op == "submit_many":
            return self._handle_submit_many(
                handle, header, payload, stage_box
            )
        if op == "submit":
            seq = int(header["seq"])
            args = unpack_tree(header["args"], payload)
            # the decoded args are zero-copy views over the pooled stage;
            # TAKE the stage out of the box — from here its lifetime is
            # the daemon's problem: it releases on every non-enqueue path
            # (even when submit raises) and, for admitted batches, after
            # the worker has placed the views on device
            stage, stage_box[0] = stage_box[0], None
            applied = handle.submit(
                *args, seq=seq, stage=stage, **self._admission(header)
            )
            return {
                "applied": applied,
                "acked_seq": handle._tenant.durable_seq,
            }, b""
        if op == "compute":
            result = handle.compute(timeout=header.get("timeout"))
            spec, blob = pack_tree(result)
            return {"result": spec}, blob
        if op == "sync_compute":
            result = handle.sync_compute(
                timeout_s=header.get("timeout_s"),
                on_failure=header.get("on_failure", "raise"),
                timeout=header.get("timeout"),
            )
            spec, blob = pack_tree(result)
            return {"result": spec}, blob
        if op == "flush":
            out = handle.flush(timeout=header.get("timeout"))
            return {"path": out["path"], "acked_seq": out["acked_seq"]}, b""
        if op == "detach":
            path = handle.detach(
                checkpoint=bool(header.get("checkpoint", False)),
                timeout=header.get("timeout"),
            )
            with self._lock:
                self._handles.pop(handle.tenant_id, None)
                self._attach_nonces.pop(handle.tenant_id, None)
                self._tenant_meta.pop(handle.tenant_id, None)
            return {"checkpoint": path}, b""
        raise AssertionError(op)  # pragma: no cover - gated above

    def _handle_submit_many(
        self,
        handle: Any,
        header: Dict[str, Any],
        payload: Any,
        stage_box: list,
    ) -> Tuple[Dict[str, Any], bytes]:
        """The client's coalesced submit: ONE frame carrying K seq'd
        batches (the wire analog of the coalesced H2D group:
        frame overhead amortizes over the group instead of repeating per
        batch). Batches apply strictly in seq order; the single pooled
        stage backing every batch's views is reference-shared so it frees
        only when the LAST batch's device placement is done. On a
        mid-group failure the error surfaces with the whole group booked
        client-side — replay + seq dedup settle the split exactly-once."""
        from torcheval_tpu_torch.serve.ingest import SharedStage

        seqs = header.get("seqs")
        batches = unpack_tree(header["args"], payload)
        if not isinstance(seqs, list) or len(seqs) != len(batches):
            raise WireError(
                "protocol",
                f"submit_many seqs/batches mismatch "
                f"({seqs!r} vs {len(batches)} batches).",
            )
        try:
            # validate BEFORE taking shares: once the SharedStage exists,
            # only handle.submit may consume a share per batch — a raise
            # from anywhere else would break the share accounting below
            seqs = [int(s) for s in seqs]
        except (TypeError, ValueError):
            raise WireError(
                "protocol", f"submit_many seqs must be ints, got {seqs!r}."
            ) from None
        # validations done: take the stage from the box — from here share
        # accounting (one per batch) owns the slot's lifetime
        stage, stage_box[0] = stage_box[0], None
        shared = (
            SharedStage(stage, len(batches))
            if stage is not None and batches
            else None
        )
        if shared is None and stage is not None:
            stage.release()  # a payload-bearing frame with zero batches
        admission = self._admission(header)
        applied = []
        try:
            for seq, args in zip(seqs, batches):
                applied.append(
                    handle.submit(*args, seq=seq, stage=shared, **admission)
                )
        except BaseException:
            if shared is not None:
                # the failing submit released its own share on its
                # no-enqueue path; the never-attempted tail's shares are
                # still ours
                for _ in range(len(batches) - len(applied) - 1):
                    shared.release()
            raise
        return {
            "applied": applied,
            "acked_seq": handle._tenant.durable_seq,
        }, b""

    @staticmethod
    def _admission(header: Dict[str, Any]) -> Dict[str, Any]:
        """Submit kwargs for the frame's transport mode. Pipelined frames
        (tagged ``gapless`` by ``_serve_pipelined``) admit gaplessly — a
        seq past a still-unadmitted hole is rejected retryably so the
        dedup watermark can never ratchet past a shed batch — and block
        briefly for queue space instead of shedding, because with a deep
        in-flight window a shed error ack forces the client into a full
        resend catch-up. Lock-step frames keep today's shed-immediately
        contract."""
        if not header.get("gapless"):
            return {}
        try:
            timeout = float(header.get("timeout") or 30.0)
        except (TypeError, ValueError):
            timeout = 30.0
        return {"gapless": True, "block": True, "timeout": timeout}

    def _negotiate_codec(self, header: Dict[str, Any]) -> Optional[str]:
        """Capability exchange: the first offered codec this server
        accepts, or ``None`` (= raw) when the client offered nothing or
        nothing overlaps. Old clients never offer; a ``codecs=()`` server
        never accepts — both degrade to raw with no protocol error."""
        offered = header.get("codecs")
        if not isinstance(offered, (list, tuple)):
            return None
        chosen = next((str(c) for c in offered if c in self._codecs), None)
        if _obs._enabled:
            _obs.counter("serve.wire.codec", codec=chosen or "raw")
        return chosen

    def _handle_attach(
        self, header: Dict[str, Any]
    ) -> Tuple[Dict[str, Any], bytes]:
        tenant_id = str(header.get("tenant"))
        nonce = header.get("nonce")
        codec = self._negotiate_codec(header)
        codec_fields = {"codec": codec} if codec else {}
        # pipeline negotiation rides the same capability exchange as the
        # codec: the client asks for a window, the server
        # grants min(ask, its own cap), and the granted depth comes back
        # in the attach ack. An old client never asks; an old server (or
        # pipeline_depth<2) never answers — either way the field is
        # absent and the wire stays lock-step with no protocol error.
        asked = header.get("pipeline")
        if (
            isinstance(asked, int)
            and not isinstance(asked, bool)
            and asked >= 2
            and self._pipeline_depth >= 2
        ):
            codec_fields["pipeline"] = min(asked, self._pipeline_depth)
        metrics = build_metrics(header.get("spec"), device=self.device)
        kwargs: Dict[str, Any] = {}
        for knob in (
            "nan_policy",
            "watchdog_timeout_s",
            "step_timeout_s",
            "queue_capacity",
            "resume",
            "window_chunks",
            "approx",
            "slices",
        ):
            if header.get(knob) is not None:
                kwargs[knob] = header[knob]
        try:
            handle = self._daemon.attach(tenant_id, metrics, **kwargs)
        except AdmissionError as e:
            if e.reason == "duplicate_tenant" and nonce is not None:
                # possibly a blind retry of OUR OWN attach whose ack was
                # lost (or whose original request is STILL mid-restore —
                # the daemon reserves the id before its checkpoint I/O):
                # attach is idempotent per nonce; wait for the original
                # to commit and re-ack its success. No submits can have
                # landed in between — the retrying client serializes
                # attach before them.
                deadline = time.monotonic() + 30.0
                while True:
                    with self._lock:
                        prior_nonce = self._attach_nonces.get(tenant_id)
                        prior_handle = self._handles.get(tenant_id)
                    if prior_handle is not None:
                        if prior_nonce == nonce:
                            return {
                                "last_seq": prior_handle._tenant.durable_seq,
                                **codec_fields,
                            }, b""
                        break  # a different caller's committed tenant
                    if (
                        not self._attach_pending(tenant_id)
                        or time.monotonic() >= deadline
                    ):
                        break  # no in-flight attach that could be ours
                    time.sleep(0.05)
            raise
        with self._lock:
            self._handles[tenant_id] = handle
            self._attach_nonces[tenant_id] = nonce
            self._tenant_meta[tenant_id] = {
                "spec": header.get("spec"),
                "knobs": dict(kwargs),
            }
        return {"last_seq": handle._tenant.durable_seq, **codec_fields}, b""

    def _attach_pending(self, tenant_id: str) -> bool:
        """True while the daemon holds ``tenant_id`` reserved for an
        in-flight admission (the restore-outside-the-lock window)."""
        daemon_lock = getattr(self._daemon, "_lock", None)
        attaching = getattr(self._daemon, "_attaching", None)
        if daemon_lock is None or attaching is None:
            return False
        with daemon_lock:
            return tenant_id in attaching

    def _tenant_handle(self, tenant_id: str):
        with self._lock:
            handle = self._handles.get(tenant_id)
        if handle is None:
            raise ServeError(
                "unknown_tenant",
                f"no tenant {tenant_id!r} attached over this wire; "
                "attach first.",
            )
        return handle
