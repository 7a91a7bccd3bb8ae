"""Zero-copy ``npz`` decoding: array views over the archive's own bytes.

JAX counterpart: ``torcheval_tpu/utils/npz.py`` (numpy only; the port keeps
its own copy, so that it imports nothing of the JAX package).
``np.load(io.BytesIO(payload))`` copies every leaf twice: once out of the
zip member stream into a fresh ``bytes`` object and once into the returned
array. An *uncompressed* npz (what :func:`np.savez` writes) needs neither
copy: every member is STORED, its ``.npy`` header pads the data to a
64-byte boundary, and the dtype/shape metadata is a one-line literal, so
each leaf can be a ``np.frombuffer`` view straight into the archive buffer.

:func:`npz_views` implements exactly that, with per-leaf fallbacks that
reproduce ``np.load(..., allow_pickle=False)`` semantics byte for byte:

* DEFLATED members, structured/object descrs, misaligned data, or any
  header surprise fall back to the stdlib ``zipfile`` + ``np.lib.format``
  copy path for THAT leaf only (``allow_pickle=False``, so an object
  array still raises ``ValueError`` exactly like ``np.load``);
* an archive that is not a zip at all returns the same errors the
  ``np.load`` path would, so callers keep their existing error mapping.

The returned views hold a reference to ``buf`` (via ``ndarray.base``), so
the archive buffer lives as long as any leaf does. Views are read-only
when ``buf`` is (a ``bytes`` payload or a read-only ``np.memmap``): wrap
one in a tensor only through a copy.

CRC note: the zero-copy path does not verify member CRCs (reading the
data to checksum it would be the copy this module exists to avoid). The
checkpoint payload (``resilience/snapshot.py``) is SHA-256-verified before
it is decoded.
"""

from __future__ import annotations

import ast
import io
import struct
import zipfile
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["npz_views", "NPZ_FORMAT_ERRORS"]

# the exception classes a caller should treat as "undecodable archive" —
# the same set the np.load path surfaces
NPZ_FORMAT_ERRORS = (ValueError, OSError, KeyError, zipfile.BadZipFile)

_LOCAL_HEADER_LEN = 30  # fixed part of a zip local file header
_NPY_MAGIC = b"\x93NUMPY"


class _BufferIO(io.RawIOBase):
    """Read-only file object over a buffer WITHOUT copying it up front
    (``io.BytesIO(memoryview)`` copies at construction). ``zipfile`` reads
    only the central directory and local headers through this on the
    zero-copy path, so the per-read ``bytes`` slices stay tiny."""

    def __init__(self, mv: memoryview) -> None:
        self._mv = mv
        self._pos = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        elif whence == io.SEEK_END:
            self._pos = len(self._mv) + offset
        else:  # pragma: no cover - zipfile never passes another whence
            raise ValueError(f"bad whence {whence}")
        self._pos = max(self._pos, 0)
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        end = len(self._mv) if n is None or n < 0 else self._pos + n
        out = bytes(self._mv[self._pos : end])
        self._pos += len(out)
        return out


def _member_views(
    buf, raw, zf: zipfile.ZipFile, zi: zipfile.ZipInfo
) -> np.ndarray:
    """One member as a zero-copy view into ``buf`` where possible, else a
    copied array via the ``np.lib.format`` reader (identical semantics to
    ``np.load(..., allow_pickle=False)``, including the object-array
    rejection)."""
    if zi.compress_type == zipfile.ZIP_STORED:
        arr = _stored_view(buf, raw, zi)
        if arr is not None:
            return arr
    with zf.open(zi.filename) as f:
        return np.lib.format.read_array(f, allow_pickle=False)


def _stored_view(buf, raw, zi: zipfile.ZipInfo) -> Optional[np.ndarray]:
    """Parse the STORED member's local header + npy header in place and
    return a ``frombuffer`` view, or ``None`` when the member needs the
    copy fallback (exotic descr, misalignment, truncation)."""
    base = zi.header_offset
    if base + _LOCAL_HEADER_LEN > len(raw):
        return None
    nlen, elen = struct.unpack_from("<HH", raw, base + 26)
    doff = base + _LOCAL_HEADER_LEN + nlen + elen
    if doff + 12 > len(raw) or bytes(raw[doff : doff + 6]) != _NPY_MAGIC:
        return None
    major = raw[doff + 6]
    if major == 1:
        (hlen,) = struct.unpack_from("<H", raw, doff + 8)
        hstart = doff + 10
    else:  # npy format 2/3: 4-byte header length
        (hlen,) = struct.unpack_from("<I", raw, doff + 8)
        hstart = doff + 12
    try:
        header = ast.literal_eval(
            bytes(raw[hstart : hstart + hlen]).decode("latin1")
        )
        descr = header["descr"]
        shape = tuple(header["shape"])
        fortran = bool(header["fortran_order"])
        if not isinstance(descr, str):
            return None  # structured dtype: fallback copies it correctly
        dtype = np.dtype(descr)
    except (ValueError, SyntaxError, KeyError, TypeError):
        return None
    if dtype.hasobject:
        return None  # the fallback raises exactly like allow_pickle=False
    dstart = hstart + hlen
    count = 1
    for dim in shape:
        count *= int(dim)
    if dstart + count * dtype.itemsize > len(raw):
        return None  # truncated member: let the checked reader complain
    arr = np.frombuffer(buf, dtype=dtype, count=count, offset=dstart)
    if not arr.flags.aligned:
        return None  # misaligned for this dtype: copy instead of a slow view
    return arr.reshape(shape, order="F" if fortran else "C")


def npz_views(buf) -> Dict[str, np.ndarray]:
    """Decode an npz archive held in ``buf`` (bytes / bytearray /
    memoryview / uint8 ndarray / mmap) into ``{name: array}`` with
    zero-copy leaf views wherever the format allows and per-leaf copy
    fallbacks everywhere else. Raises the same exception classes the
    ``np.load`` path would for an unusable archive
    (:data:`NPZ_FORMAT_ERRORS`)."""
    # bytes payloads ride BytesIO's zero-copy sharing of immutable bytes;
    # everything else (pooled buffers, mmaps) goes through the no-copy
    # _BufferIO wrapper — either way the archive is never duplicated
    if isinstance(buf, bytes):
        raw: Any = buf
        f: Any = io.BytesIO(buf)
    else:
        raw = memoryview(buf)
        f = _BufferIO(raw)
    with zipfile.ZipFile(f) as zf:
        out: Dict[str, np.ndarray] = {}
        for zi in zf.infolist():
            name = zi.filename
            key = name[:-4] if name.endswith(".npy") else name
            out[key] = _member_views(buf, raw, zf, zi)
        return out


def _views_share_buffer(arrays: Dict[str, np.ndarray], buf: Any) -> bool:
    """Test helper: every array leaf is a view (no owned data)."""
    return all(not a.flags.owndata for a in arrays.values())
