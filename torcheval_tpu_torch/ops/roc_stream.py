"""The exact binary AUROC's stream route on the card: one stable radix sort
of (order key, label) pairs and one pass over the sorted stream, with no
index permutation.

JAX counterpart: none. The JAX package computes the same value with
``torcheval_tpu/ops/curves.py::binary_auroc_kernel`` (a sort that carries
an index, a gather of the labels, and reverse ``cummin`` scans to the tie
groups' ends), which the port keeps as its composition
(``ops/curves.py``): on the CPU, for ``(C, N)`` rows, and as this route's
reference. ``binary_auroc_kernel`` sends a 1-D score column on the card
here, and ``binary_auroc_parts`` a raw cache's parts as they lie.

Three steps, each a C entry of the kernels' library:

* the key pass (``csrc/roc_stream.cu``, ``tc_roc_keys``), one launch a
  raw-cache tensor, read where it lies: a uint32 order key a row (ascending
  keys are descending scores; -0.0 and +0.0 one key; every NaN the last key,
  :data:`NAN_KEY`) and the target's int32 cast as a one-byte label, at the
  tensor's offset in the stream; a target whose cast is not 0 or 1 sets a
  device flag;
* the sort (``csrc/roc_sort.cu``, ``tc_roc_sort``): the library's stable
  radix sort of the pairs, through a double buffer;
* the integration (``csrc/roc_stream.cu``, ``tc_roc_integrate``): the
  trapezoid over the tie-group ends in int64, ``area / (2 P N)`` in double,
  returned as float32.

:func:`binary_auroc_stream` runs the three on one allocation and returns
None when the flag is set: such targets take the composition, whose value
this route's one-byte labels cannot give. It reads the flag on the host
through an event recorded right after the key pass, so the read waits for
the key pass (and the work queued before it), not for the sort and
integration queued behind it; bool targets skip the read. Each C entry
call counts one ``roc_stream.launches{step=keys|sort|integrate}`` while
obs is on (a port-only counter, not ``jit.calls``: the route is no entry
of its own). :func:`binary_auroc_stream_plain` is the same arithmetic in
plain PyTorch, which the CPU tests hold to the composition and the JAX
package, and the card tests and ``chip_smoke.py`` hold the kernels to; it
is no route of ``binary_auroc_kernel``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from torcheval_tpu_torch import _build
from torcheval_tpu_torch.obs import registry as _obs

# the key of every NaN score: after every real score's key, -inf's included
NAN_KEY = 0xFFFFFFFF
# score types float32 holds exactly, so their keys tie where they do
STREAM_SCORES = (torch.float32, torch.float16, torch.bfloat16)
# the key pass's target codes (csrc/roc_stream.cu, tc_roc_keys); any other
# type is cast to int32 first, as the composition casts every target
_TARGET_CODES = {torch.int32: 0, torch.uint8: 1, torch.bool: 1, torch.float32: 2}
_ALIGN = 256


def order_keys_plain(scores: torch.Tensor) -> torch.Tensor:
    """The key pass's uint32 order keys of ``scores`` (cast to float32), as
    int64: ascending keys are descending scores, -0.0 and +0.0 share one,
    and every NaN gets :data:`NAN_KEY`."""
    x = scores.to(torch.float32).contiguous().reshape(-1)
    b = (x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) ^ 0x80000000  # -x
    b = torch.where((b & 0x7FFFFFFF) == 0, 0, b)
    key = torch.where((b & 0x80000000) != 0, b ^ 0xFFFFFFFF, b | 0x80000000)
    return torch.where(torch.isnan(x), NAN_KEY, key)


def _parts(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def binary_auroc_stream_plain(scores, targets):
    """The stream route's arithmetic in plain PyTorch: ``(auroc, area,
    positives)``, the float32 AUROC and the int64 doubled area and count
    of positives as Python ints, over ``scores`` and ``targets`` (tensors,
    or lists of a raw cache's parts); None when a target's int32 cast is
    not 0 or 1."""
    s = torch.cat([p.reshape(-1).to(torch.float32) for p in _parts(scores)])
    t = torch.cat([p.reshape(-1).to(torch.int32) for p in _parts(targets)])
    if not bool(((t == 0) | (t == 1)).all()):
        return None
    n = s.numel()
    if n == 0:
        return torch.tensor(0.5, device=s.device), 0, 0
    keys, order = torch.sort(order_keys_plain(s), stable=True)
    tp = torch.cumsum(t[order].to(torch.int64), 0)
    fp = torch.arange(1, n + 1, device=s.device) - tp
    end = (keys == NAN_KEY).clone()
    end[:-1] |= keys[:-1] != keys[1:]
    end[-1] = True
    etp, efp = tp[end], fp[end]
    zero = etp.new_zeros(1)
    ptp, pfp = torch.cat([zero, etp[:-1]]), torch.cat([zero, efp[:-1]])
    area = int(((efp - pfp) * (etp + ptp)).sum())
    p = int(tp[-1])
    q = n - p
    auc = 0.5 if p == 0 or q == 0 else area / (2.0 * p * q)
    return torch.tensor(auc, dtype=torch.float32, device=s.device), area, p


def _key_operands(scores: torch.Tensor, targets: torch.Tensor):
    """A part's operands as the key pass reads them: float32 scores (exact
    from float16 and bfloat16), targets of a type it has a code for (others
    cast to int32), both contiguous."""
    if scores.ndim != 1 or targets.shape != scores.shape:
        raise ValueError(
            "the AUROC's stream route wants scores (N,) with targets (N,), got "
            f"{tuple(scores.shape)} / {tuple(targets.shape)}."
        )
    if targets.dtype not in _TARGET_CODES:
        targets = targets.to(torch.int32)
    code = _TARGET_CODES[targets.dtype]
    if targets.dtype == torch.bool:
        targets = targets.view(torch.uint8)
    return scores.to(torch.float32).contiguous(), targets.contiguous(), code


def _count_launch(step: str) -> None:
    if _obs._enabled:
        _obs.counter("roc_stream.launches", step=step)


def _key_pass(lib, scores, targets, keys, labels, flag) -> None:
    """One ``tc_roc_keys`` launch a part, each at its offset in the stream."""
    off = 0
    for s, t in zip(scores, targets):
        s, t, code = _key_operands(s, t)
        _build.require_cuda("roc_stream", s, t, keys)
        n = s.shape[0]
        err = lib.tc_roc_keys(
            code, s.data_ptr(), t.data_ptr(), n, keys.data_ptr() + 4 * off,
            labels.data_ptr() + off, flag.data_ptr(), _build.stream_of(keys),
        )
        _build.check(err, "roc_stream (key pass)")
        _count_launch("keys")
        off += n


def _sort(lib, keys, keys_alt, labels, labels_alt, scratch):
    """The sorted pairs: ``(keys, labels)`` or their second buffers."""
    selector = ctypes.c_int(0)
    err = lib.tc_roc_sort(
        keys.data_ptr(), keys_alt.data_ptr(), labels.data_ptr(), labels_alt.data_ptr(),
        keys.numel(), scratch.data_ptr(), scratch.numel(), ctypes.byref(selector),
        _build.stream_of(keys),
    )
    _build.check(err, "roc_stream (sort)")
    _count_launch("sort")
    return (keys_alt, labels_alt) if selector.value else (keys, labels)


def _integrate(lib, keys, labels, scratch, totals, out) -> None:
    err = lib.tc_roc_integrate(
        keys.data_ptr(), labels.data_ptr(), keys.numel(), scratch.data_ptr(),
        totals.data_ptr(), out.data_ptr(), _build.stream_of(keys),
    )
    _build.check(err, "roc_stream (integration)")
    _count_launch("integrate")


def _sort_scratch_bytes(lib, n: int) -> int:
    size = lib.tc_roc_sort_scratch(n)
    if size < 0:
        raise RuntimeError(f"roc_stream: the radix sort refuses {n} rows.")
    return size


def _carve(n: int, lib, device: torch.device):
    """One allocation for a call's large buffers: the keys and labels, the
    sort's second buffers, and the sort's and the integration's scratch,
    each at a 256-byte boundary."""
    sizes = (4 * n, 4 * n, n, n, _sort_scratch_bytes(lib, n), lib.tc_roc_integrate_scratch(n))
    starts, total = [], 0
    for size in sizes:
        starts.append(total)
        total += (size + _ALIGN - 1) // _ALIGN * _ALIGN
    block = torch.empty(total, dtype=torch.uint8, device=device)
    keys, keys_alt, labels, labels_alt, sort_scratch, int_scratch = (
        block[a:a + size] for a, size in zip(starts, sizes)
    )
    return (keys.view(torch.int32), keys_alt.view(torch.int32), labels, labels_alt,
            sort_scratch, int_scratch)


def _flag_reader(flag: torch.Tensor):
    """A callable that gives ``flag``'s value as it stands at this point of
    the stream: a copy into pinned host memory and an event recorded now,
    so that the call waits for the work queued so far and no more."""
    host = torch.empty((), dtype=flag.dtype, pin_memory=True)
    host.copy_(flag, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(flag.device))

    def read() -> int:
        done.synchronize()
        return int(host)

    return read


def _rows(scores: Sequence[torch.Tensor]) -> int:
    n = sum(int(s.shape[0]) for s in scores)
    if n >= 1 << 31:
        raise ValueError(f"the AUROC's stream route takes fewer than 2^31 rows, got {n}.")
    return n


def binary_auroc_stream(scores, targets) -> Optional[torch.Tensor]:
    """The exact AUROC, float32 ``()``, of 1-D CUDA ``scores`` and
    ``targets`` (tensors, or lists of a raw cache's parts, read where they
    lie), or None when some target's int32 cast is not 0 or 1. Scores are
    float32, float16 or bfloat16. Launches the key pass (one launch a
    part), the sort and the integration on PyTorch's current stream; an
    empty stream launches nothing and gives 0.5."""
    scores, targets = _parts(scores), _parts(targets)
    if len(scores) != len(targets) or not scores:
        raise ValueError("the AUROC's stream route wants one target part a score part.")
    dev = scores[0].device
    n = _rows(scores)
    if n == 0:
        return torch.full((), 0.5, dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        keys, keys_alt, labels, labels_alt, sort_scratch, int_scratch = _carve(n, lib, dev)
        # the doubled area, the positives, and the flag's word
        totals = torch.zeros(3, dtype=torch.int64, device=dev)
        flag = totals[2:].view(torch.int32)[:1]
        _key_pass(lib, scores, targets, keys, labels, flag)
        read_flag = None
        if any(t.dtype != torch.bool for t in targets):
            read_flag = _flag_reader(totals[2])
        keys, labels = _sort(lib, keys, keys_alt, labels, labels_alt, sort_scratch)
        out = torch.empty((), dtype=torch.float32, device=dev)
        _integrate(lib, keys, labels, int_scratch, totals, out)
    if read_flag is not None and read_flag():
        return None
    return out

