"""Byte-shrinking codecs of the quantized sync.

JAX counterpart: ``torcheval_tpu/utils/quant.py``, with the same byte
format, so that each package decodes the other's payloads. These are the
host-side primitives of the toolkit's quantized lanes
(``metrics/toolkit.py``); the distributed curves' quantized exchange (a
narrow label column, a bf16 or int8 splitter histogram) is in
``ops/dist_curves.py``.

Three primitives, two loss classes:

* **narrow-int** (lossless): an integer array whose value *span* fits a
  narrower unsigned width ships as ``min`` (8 bytes) + ``width`` (1 byte)
  + ``(x - min)`` in that width. Decoding widens back to the declared
  dtype before any accumulation, so folding narrowed count lanes is
  bit-exact.
* **delta-int** (lossless): consecutive differences (in int64), then the
  same min-offset narrowing. Monotone sequences (sorted ids) narrow to
  their step size.
* **q8 block quantization** (bounded error): int8 blocks of
  :data:`Q8_BLOCK` elements with one float32 scale per block
  (``scale = max|block| / 127``). The error of an element is at most
  ``scale / 2 = max|block| / 254``; the encoded size is
  ``n + 4 * ceil(n / 256)`` bytes against ``4n`` raw (about 3.94x fewer
  bytes). Non-finite blocks do not quantize: callers send those raw.

The **bucket payload** (lossless) ships only the nonzero entries of an
integer array, as delta-narrowed indices and narrowed values: the sparse
sketch histograms' natural shape.

Every encoder returns ``None`` when encoding would not shrink the payload
(scalars, tiny arrays, already-narrow dtypes, spans too wide), so a codec
can be applied unconditionally and degrade to raw per entry. Arrays below
:data:`Q8_MIN_ELEMENTS` never quantize: small float32 states (the scalar
counters most metrics carry) stay bit-exact with quantization on.

The knobs are the JAX package's: ``TORCHEVAL_TPU_SYNC_QUANTIZE``, read by
:func:`sync_quantize_enabled` (the toolkit) and :func:`sync_quantize_mode`
(the distributed curves), and ``TORCHEVAL_TPU_WIRE_CODEC``, read by
:func:`wire_codec_default` (the serve wire's client).
"""

from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "Q8_BLOCK",
    "Q8_MIN_ELEMENTS",
    "sync_quantize_enabled",
    "sync_quantize_mode",
    "wire_codec_default",
    "bucket_payload_encode",
    "bucket_payload_decode",
    "q8_parts",
    "q8_from_parts",
    "q8_encode",
    "q8_decode",
    "narrow_int_encode",
    "narrow_int_decode",
    "delta_int_parts",
    "delta_int_from_parts",
    "delta_int_encode",
    "delta_int_decode",
]

# elements per q8 block (one f32 scale each). 256 keeps the scale
# overhead at ~1.6% while bounding each element's error to its own
# block's dynamic range, not the whole array's.
Q8_BLOCK = 256

# below this element count quantization cannot meaningfully win (the
# scale overhead eats the gain) and scalar states would lose exactness
# for nothing — they stay raw even when quantization is forced on.
Q8_MIN_ELEMENTS = 64

_SYNC_QUANTIZE_ENV = "TORCHEVAL_TPU_SYNC_QUANTIZE"
_WIRE_CODEC_ENV = "TORCHEVAL_TPU_WIRE_CODEC"


# env spellings that mean "off", as the TORCHEVAL_TPU_APPROX parser reads
# them, so that 'false'/'off' never turn the codecs on; compared without
# case
_QUANTIZE_OFF = ("0", "", "false", "off")


def _sync_quantize_env() -> str:
    return os.environ.get(_SYNC_QUANTIZE_ENV, "0").strip().lower()


def sync_quantize_enabled(override: Optional[bool] = None) -> bool:
    """Resolve the metric-sync quantization knob: an explicit per-call
    ``quantize=`` wins; otherwise the ``TORCHEVAL_TPU_SYNC_QUANTIZE``
    environment variable — ``0``/empty/``false``/``off`` = off (any
    case), ``1``/``true``/``on``/``bf16``/``int8`` = on, anything else
    raises (delegated to :func:`sync_quantize_mode` so the env is
    validated identically everywhere)."""
    if override is not None:
        return bool(override)
    return sync_quantize_mode() is not False


def sync_quantize_mode(override=None):
    """The distributed curves' splitter-histogram reduction behind the same
    knob: ``False`` (the exact int32 all-reduce), ``"bf16"`` (half the
    bytes; ``quantize=True`` or env ``"1"``) or ``"int8"`` (the int8-block
    reduce-scatter and all-gather, about a quarter of the bytes;
    ``quantize="int8"`` or env ``"int8"``, any case). Either lossy mode can
    only move the splitters, never a curve value (``ops/dist_curves.py``,
    "Quantized exchange")."""
    if override is not None:
        if isinstance(override, str):
            # a string is a mode name: a typo raises instead of reading
            # as a true value (the bf16 mode)
            mode = override.strip().lower()
            if mode not in ("bf16", "int8"):
                raise ValueError(
                    f'quantize mode must be "bf16" or "int8" (or a bool), '
                    f"got {override!r}."
                )
            return mode
        return "bf16" if override else False
    env = _sync_quantize_env()
    if env in _QUANTIZE_OFF:
        return False
    if env == "int8":
        return "int8"
    if env in ("1", "true", "on", "bf16"):
        return "bf16"
    # a typo ("in8t") raises, as a mode name passed per call does
    raise ValueError(
        f"{_SYNC_QUANTIZE_ENV} must be 0/1/true/false/on/off/bf16/int8, "
        f"got {env!r}."
    )


def wire_codec_default() -> str:
    """The cluster-wire codec a client prefers when none is passed:
    ``TORCHEVAL_TPU_WIRE_CODEC`` (``raw`` / ``delta`` / ``qblk``),
    default ``raw``. ``delta`` is lossless and safe fleet-wide; ``qblk``
    additionally block-quantizes f32 leaves (bounded error, see module
    doc) and is an explicit opt-in."""
    return os.environ.get(_WIRE_CODEC_ENV, "raw")


# ------------------------------------------------------- q8 block quant
def q8_parts(
    arr: np.ndarray, *, check_finite: bool = True
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Block-quantize a float32 array: ``(scales f32[nblocks], q int8[n])``
    or ``None`` when the array is too small, non-f32, or non-finite
    (caller falls back to raw — the error-channel contract).
    ``check_finite=False`` skips the finiteness scan for callers that
    already ran it (the sync wire checks once to count its fallback) —
    non-finite input then produces garbage, so only pass it after a real
    check."""
    if arr.dtype != np.float32 or arr.size < Q8_MIN_ELEMENTS:
        return None
    flat = np.ascontiguousarray(arr).reshape(-1)
    if check_finite and not np.isfinite(flat).all():
        return None
    n = flat.size
    nblocks = -(-n // Q8_BLOCK)
    pad = nblocks * Q8_BLOCK - n
    padded = np.concatenate([flat, np.zeros(pad, np.float32)]) if pad else flat
    blocks = padded.reshape(nblocks, Q8_BLOCK)
    scales = (np.abs(blocks).max(axis=1) / 127.0).astype(np.float32)
    safe = np.where(scales == 0.0, np.float32(1.0), scales)
    q = np.clip(np.rint(blocks / safe[:, None]), -127, 127).astype(np.int8)
    return scales, q.reshape(-1)[:n]


def q8_from_parts(
    scales: np.ndarray, q: np.ndarray, shape: Tuple[int, ...]
) -> np.ndarray:
    """Dequantize :func:`q8_parts` output back to float32 of ``shape``."""
    scales = np.asarray(scales, dtype=np.float32).reshape(-1)
    q = np.asarray(q, dtype=np.int8).reshape(-1)
    n = q.size
    nblocks = scales.size
    pad = nblocks * Q8_BLOCK - n
    padded = (
        np.concatenate([q, np.zeros(pad, np.int8)]) if pad else q
    ).reshape(nblocks, Q8_BLOCK)
    out = (padded.astype(np.float32) * scales[:, None]).reshape(-1)[:n]
    return out.reshape(shape)


def q8_encode(
    arr: np.ndarray, *, check_finite: bool = True
) -> Optional[bytes]:
    """:func:`q8_parts` as one byte string (scales then quants) for the
    sync wire's concatenated payload round. ``None`` when quantization
    does not apply or would not shrink the entry."""
    parts = q8_parts(arr, check_finite=check_finite)
    if parts is None:
        return None
    scales, q = parts
    out = scales.tobytes() + q.tobytes()
    return out if len(out) < arr.nbytes else None


def q8_decode(buf: bytes, shape: Tuple[int, ...]) -> np.ndarray:
    """Inverse of :func:`q8_encode` (shape comes from the descriptor)."""
    n = 1
    for d in shape:
        n *= int(d)
    nblocks = -(-n // Q8_BLOCK)
    scales = np.frombuffer(buf, dtype=np.float32, count=nblocks)
    q = np.frombuffer(buf, dtype=np.int8, count=n, offset=4 * nblocks)
    return q8_from_parts(scales, q, shape)


# ------------------------------------------------------------ narrow-int
_NARROW_HEAD = struct.Struct("<qB")  # int64 min, uint8 byte width


def _narrow_width(span: int) -> Optional[int]:
    if span <= 0xFF:
        return 1
    if span <= 0xFFFF:
        return 2
    if span <= 0xFFFFFFFF:
        return 4
    return None


def narrow_int_encode(arr: np.ndarray) -> Optional[bytes]:
    """Lossless min-offset narrowing of an integer array; ``None`` when
    it would not shrink (empty, span too wide, dtype already narrow, or
    values outside int64's exact range)."""
    if arr.dtype.kind not in "iu" or arr.size == 0:
        return None
    flat = np.ascontiguousarray(arr).reshape(-1)
    lo, hi = int(flat.min()), int(flat.max())
    if lo < -(2**63) or hi >= 2**63:  # uint64 beyond int64: bail
        return None
    width = _narrow_width(hi - lo)
    if width is None or width >= arr.dtype.itemsize:
        return None
    data = (flat.astype(np.int64) - lo).astype(f"<u{width}")
    out = _NARROW_HEAD.pack(lo, width) + data.tobytes()
    return out if len(out) < arr.nbytes else None


def narrow_int_decode(
    buf: bytes, dtype: np.dtype, shape: Tuple[int, ...]
) -> np.ndarray:
    """Inverse of :func:`narrow_int_encode`, widening back to ``dtype``
    BEFORE any accumulation touches the values (bit-exact folds)."""
    lo, width = _NARROW_HEAD.unpack_from(buf)
    n = 1
    for d in shape:
        n *= int(d)
    data = np.frombuffer(
        buf, dtype=f"<u{width}", count=n, offset=_NARROW_HEAD.size
    )
    return (data.astype(np.int64) + lo).astype(dtype).reshape(shape)


# ------------------------------------------------------------- delta-int
def delta_int_parts(
    arr: np.ndarray,
) -> Optional[Tuple[int, np.ndarray]]:
    """Delta + min-offset narrowing (the bucket payload's indices): returns
    ``(offset, deltas-minus-offset as a narrow unsigned array)`` or
    ``None`` when it would not shrink. Lossless: ``cumsum`` of the
    restored int64 deltas reproduces the values exactly."""
    if arr.dtype.kind not in "iu" or arr.size == 0:
        return None
    flat = np.ascontiguousarray(arr).reshape(-1)
    lo, hi = int(flat.min()), int(flat.max())
    if lo < -(2**62) or hi >= 2**62:  # keep every delta exact in int64
        return None
    d = np.diff(flat.astype(np.int64), prepend=np.int64(0))
    dlo = int(d.min())
    width = _narrow_width(int(d.max()) - dlo)
    if width is None or width >= arr.dtype.itemsize:
        return None
    return dlo, (d - dlo).astype(f"<u{width}")


def delta_int_from_parts(
    data: np.ndarray, offset: int, dtype: np.dtype, shape: Tuple[int, ...]
) -> np.ndarray:
    """Inverse of :func:`delta_int_parts`."""
    d = np.asarray(data).astype(np.int64) + int(offset)
    return np.cumsum(d).astype(dtype).reshape(shape)


def delta_int_encode(arr: np.ndarray) -> Optional[bytes]:
    """:func:`delta_int_parts` as one byte string (same header layout as
    narrow-int: int64 offset + uint8 width + data)."""
    parts = delta_int_parts(arr)
    if parts is None:
        return None
    offset, data = parts
    out = _NARROW_HEAD.pack(offset, data.dtype.itemsize) + data.tobytes()
    return out if len(out) < arr.nbytes else None


def delta_int_decode(
    buf: bytes, dtype: np.dtype, shape: Tuple[int, ...]
) -> np.ndarray:
    """Inverse of :func:`delta_int_encode`."""
    offset, width = _NARROW_HEAD.unpack_from(buf)
    n = 1
    for d in shape:
        n *= int(d)
    data = np.frombuffer(
        buf, dtype=f"<u{width}", count=n, offset=_NARROW_HEAD.size
    )
    return delta_int_from_parts(data, offset, dtype, shape)


# ----------------------------------------------------------- bucket payload
# The resident sketch state (fixed-size bucket histograms: Cat's approx
# mode, the curve sketches, Quantile) is int32 counts that are typically
# sparse: a stream's score cardinality occupies a small fraction of the
# 2^16 buckets. Min-offset narrowing alone still ships
# every zero; this codec ships only the nonzero buckets — delta-narrowed
# indices (sorted, so deltas are tiny) plus narrowed values — and degrades
# per part: the index block falls back to raw u32, the value block to raw
# dtype bytes, and the whole encoder to None when it would not shrink.
# Decode is faithful for ANY integer array (scatter into zeros), so the
# sync wire may offer it on every integer lane and pick the smaller of
# narrow/bucket per entry.
_BUCKET_HEAD = struct.Struct("<IBBI")  # nnz, idx_mode, val_mode, idx_nbytes
_BUCKET_RAW, _BUCKET_PACKED = 0, 1


def bucket_payload_encode(arr: np.ndarray) -> Optional[bytes]:
    """Sparse nonzero encoding of an integer bucket-count array; ``None``
    when it would not shrink the raw payload (dense arrays — the caller
    then tries/keeps min-offset narrowing)."""
    if arr.dtype.kind not in "iu" or arr.size == 0 or arr.size >= 2**32:
        return None
    flat = np.ascontiguousarray(arr).reshape(-1)
    idx = np.flatnonzero(flat)
    if idx.size >= 2**32:
        return None
    # dense lower bound: the output can never beat header + 1 index byte +
    # 1 value byte per nonzero — bail before building the real encodings
    # (a dense lane on the sync hot path otherwise pays flatnonzero +
    # int64 index copies + two encoders just to fail the final size check)
    if _BUCKET_HEAD.size + 2 * idx.size >= arr.nbytes:
        return None
    if idx.size == 0:
        out = _BUCKET_HEAD.pack(0, _BUCKET_RAW, _BUCKET_RAW, 0)
        return out if len(out) < arr.nbytes else None
    vals = flat[idx]
    idx_enc = delta_int_encode(idx.astype(np.int64))
    if idx_enc is not None:
        idx_mode, idx_part = _BUCKET_PACKED, idx_enc
    else:  # tiny nnz: the delta header does not amortize
        idx_mode, idx_part = _BUCKET_RAW, idx.astype("<u4").tobytes()
    val_enc = narrow_int_encode(vals)
    if val_enc is not None:
        val_mode, val_part = _BUCKET_PACKED, val_enc
    else:
        val_mode, val_part = _BUCKET_RAW, vals.tobytes()
    out = (
        _BUCKET_HEAD.pack(idx.size, idx_mode, val_mode, len(idx_part))
        + idx_part
        + val_part
    )
    return out if len(out) < arr.nbytes else None


def bucket_payload_decode(
    buf: bytes, dtype: np.dtype, shape: Tuple[int, ...]
) -> np.ndarray:
    """Inverse of :func:`bucket_payload_encode`: scatter the nonzero
    values back into a zeros array of the declared dtype/shape (widening
    happens before any accumulation — bit-exact folds, the narrow-int
    contract)."""
    nnz, idx_mode, val_mode, idx_nbytes = _BUCKET_HEAD.unpack_from(buf)
    out = np.zeros(shape, dtype=dtype).reshape(-1)
    if nnz == 0:
        return out.reshape(shape)
    off = _BUCKET_HEAD.size
    idx_buf = buf[off : off + idx_nbytes]
    if idx_mode == _BUCKET_PACKED:
        idx = delta_int_decode(idx_buf, np.dtype(np.int64), (nnz,))
    else:
        idx = np.frombuffer(idx_buf, dtype="<u4", count=nnz).astype(np.int64)
    val_buf = buf[off + idx_nbytes :]
    if val_mode == _BUCKET_PACKED:
        vals = narrow_int_decode(val_buf, dtype, (nnz,))
    else:
        vals = np.frombuffer(val_buf, dtype=dtype, count=nnz)
    out[idx] = vals
    return out.reshape(shape)
