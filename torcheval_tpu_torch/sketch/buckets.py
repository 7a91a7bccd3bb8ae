"""Float-prefix bucket mapping: the one bucket family behind every sketch.

JAX counterpart: ``torcheval_tpu/sketch/buckets.py``. A sketch needs a
fixed, distribution-independent, monotone partition of the float line, so
that bucket counts from any two streams merge by plain addition and the
bucket id is a pure function of the value on every device.

The bucket id is the top ``bucket_bits`` bits of a monotone 32-bit order
key: every float32 maps through a sign-aware bitcast to a key whose
unsigned order is the float order. The key's layout is ``[sign][8-bit
exponent][mantissa]``, so with ``bucket_bits >= 10`` a bucket never spans an
exponent boundary and every value in a bucket is within
``relative_error(bucket_bits) = 2**-(bucket_bits - 9)`` of its
representative. Negatives, ``+-0`` (one bucket), ``+-inf`` and every
magnitude are covered. NaN has no order: it maps to the top key, and the
folds mask it and count it apart.

**The key is built in int64.** PyTorch's ``uint32`` supports few
operations, and an ``int32`` view of ``b | 0x80000000`` is negative, so a
right shift of it would extend the sign. The bits are read with
``x.view(torch.int32)``, widened to int64 and masked with ``0xFFFFFFFF``;
every operation after that is on non-negative int64 values below 2^32.

**Subnormals flush explicitly.** ``|x| < finfo(float32).tiny`` becomes
``+0.0`` before the bitcast, as in the JAX package: the CUDA kernels keep
subnormals (no flush-to-zero) where XLA on the CPU flushes them, and the
bucket id must not depend on the device. Half-precision inputs are widened
to float32 first (exact), as the JAX package's ``astype`` does.

The edges and representatives are numpy, computed on the host once per
``bucket_bits`` and equal to the JAX package's bit for bit;
:func:`representatives_on` keeps one device copy per ``(bits, device)``.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

# 2^16 buckets: 256 KiB per int32 histogram, relative error 2^-7
DEFAULT_BUCKET_BITS = 16
# multiclass state is (C, B) twice: 2^12 buckets keep 1000 classes at 32 MiB
DEFAULT_MC_BUCKET_BITS = 12
# below 10 bits a bucket spans exponent boundaries; above 20 the memory
# bound stops being small
MIN_BUCKET_BITS, MAX_BUCKET_BITS = 10, 20

_NAN_KEY = 0xFFFFFFFF
_SIGN = 0x80000000
_TINY = float(np.finfo(np.float32).tiny)


def check_bucket_bits(bucket_bits: int) -> int:
    if (
        not isinstance(bucket_bits, int)
        or not MIN_BUCKET_BITS <= bucket_bits <= MAX_BUCKET_BITS
    ):
        raise ValueError(
            f"bucket_bits must be an int in [{MIN_BUCKET_BITS}, "
            f"{MAX_BUCKET_BITS}], got {bucket_bits!r}."
        )
    return bucket_bits


def relative_error(bucket_bits: int) -> float:
    """The bound on ``|representative - value| / |value|`` for any finite
    normal value (a full bucket width; the midpoint typically halves it).
    Subnormal values flush to the zero bucket, an absolute error below
    1.18e-38."""
    return 2.0 ** -(check_bucket_bits(bucket_bits) - 9)


def ascending_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone order key as int64 in ``[0, 2^32)``: ``key(a) < key(b)``
    iff ``a < b``; ``-0.0``, ``+0.0`` and every subnormal share the zero
    key; NaN maps to ``0xFFFFFFFF``.

    The card's fused score fold builds the same key in registers
    (``csrc/scatter.cu::score_bucket``): a change here is made there too,
    and ``tests/test_torch_cuda.py::test_fused_score_fold_equals_the_composition``
    holds the two to the same counts."""
    x = x.to(torch.float32)
    x = torch.where(x.abs() < _TINY, 0.0, x)  # subnormals and -0.0 to +0.0
    b = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(b >= _SIGN, b ^ 0xFFFFFFFF, b | _SIGN)
    return torch.where(torch.isnan(x), _NAN_KEY, key)


def bucket_index(x: torch.Tensor, bucket_bits: int) -> torch.Tensor:
    """int32 bucket id in ``[0, 2**bucket_bits)`` of every element (NaN in
    the top bucket: the folds mask it out). Elementwise tensor ops only, so
    it runs under ``torch.func.vmap``."""
    return (ascending_key(x) >> (32 - bucket_bits)).to(torch.int32)


def _key_to_float(key: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`ascending_key` (numpy)."""
    key = np.asarray(key, dtype=np.uint32)
    positive = (key & np.uint32(0x80000000)) != 0
    bits = np.where(positive, key & np.uint32(0x7FFFFFFF), ~key).astype(np.uint32)
    return bits.view(np.float32)


@functools.lru_cache(maxsize=None)
def bucket_edges(bucket_bits: int):
    """``(lo, hi)`` float32 arrays of every bucket's inclusive value edges,
    ascending by bucket id. Buckets inside the key space's NaN regions have
    NaN edges (they can never hold a count)."""
    check_bucket_bits(bucket_bits)
    shift = 32 - bucket_bits
    ids = np.arange(1 << bucket_bits, dtype=np.uint64)
    lo_key = (ids << shift).astype(np.uint32)
    hi_key = ((ids << shift) + ((1 << shift) - 1)).astype(np.uint32)
    lo = _key_to_float(lo_key)
    hi = _key_to_float(hi_key)
    # the +-inf buckets' outward edges decode into NaN patterns: clamp them
    # to the inward edge
    lo = np.where(np.isnan(lo) & ~np.isnan(hi), hi, lo)
    hi = np.where(np.isnan(hi) & ~np.isnan(lo), lo, hi)
    lo.setflags(write=False)
    hi.setflags(write=False)
    return lo, hi


@functools.lru_cache(maxsize=None)
def bucket_representatives(bucket_bits: int) -> np.ndarray:
    """Per-bucket representative value, float32, ascending by bucket id:
    the float64 midpoint of the edges rounded once. The ``+-inf`` buckets
    keep their infinite edge; NaN-region buckets stay NaN (padding rows of
    the curve functions, which never hold a count)."""
    lo, hi = bucket_edges(bucket_bits)
    with np.errstate(invalid="ignore"):
        mid = ((lo.astype(np.float64) + hi.astype(np.float64)) / 2.0).astype(np.float32)
    mid = np.where(np.isnan(mid) & ~np.isnan(lo), lo, mid)
    mid = np.where(np.isnan(mid) & ~np.isnan(hi), hi, mid)
    mid.setflags(write=False)
    return mid


_ON_DEVICE: Dict[Tuple[int, str, bool], torch.Tensor] = {}


def representatives_on(bucket_bits: int, device, descending: bool = False) -> torch.Tensor:
    """:func:`bucket_representatives` as a float32 tensor on ``device``
    (reversed with ``descending``: the presorted curve functions' row
    order), copied there once per ``(bits, device, order)`` and shared
    afterwards: a compute never pays a host copy. Callers must not write
    into it."""
    key = (int(bucket_bits), str(torch.device(device)), bool(descending))
    reps = _ON_DEVICE.get(key)
    if reps is None:
        host = bucket_representatives(bucket_bits)
        host = host[::-1] if descending else host
        reps = torch.from_numpy(host.copy()).to(device)
        _ON_DEVICE[key] = reps
    return reps
