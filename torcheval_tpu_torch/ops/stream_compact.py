"""Stable stream compaction: the CUDA kernel ``csrc/stream_compact.cu`` and its
plain version.

JAX counterpart: ``torcheval_tpu/ops/stream_compact.py`` (``stream_compact``,
``compact_summary_rows``, the Pallas kernel ``_compact_kernel``). The
contract is the same: the rows where ``mask`` is nonzero move to the front
of every column, in input order, and ``n_live`` (an int32 device scalar)
counts them. The kernel moves raw 32-bit words, so the JAX package's
bit-splitting helpers (``split_f32_bits``, ``split_i32``) and its rule that
live payloads be finite, which existed only for the TPU's permutation
matmul, have no counterpart here: NaN, +-inf and -0.0 move bit for bit.

:func:`stream_compact` runs the kernel on CUDA tensors and raises if it
cannot; :func:`stream_compact_plain` (``nonzero`` + ``index_select``) is the
same function in plain PyTorch, which :func:`stream_compact` runs for CPU
tensors and which tests and ``chip_smoke.py`` hold the kernel against.

Both entries are watched by the recompile watchdog (``obs/recompile.py``),
as ``stream_compact`` and ``compact_summary_rows``; each launch counts one
``jit.calls{entry=stream_compact}`` while obs is enabled, and the byte
model (:func:`_moved`: the mask and the columns read once, every output
row and the count written once) feeds both entries' cost gauges.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from torcheval_tpu_torch import _build
from torcheval_tpu_torch.obs.cost import nbytes
from torcheval_tpu_torch.obs.recompile import count_launch, watched
from torcheval_tpu_torch.ops.summary import PAD_SCORE

MAX_COLS = 7
_NUMPY = {torch.float32: np.float32, torch.int32: np.int32, torch.uint32: np.uint32}


Pad = Optional[Sequence[float]]


def _check(mask: torch.Tensor, cols: Sequence[torch.Tensor], pad: Pad) -> None:
    if mask.ndim != 1:
        raise ValueError(f"mask must be 1-D, got shape {tuple(mask.shape)}.")
    if len(cols) > MAX_COLS:
        raise ValueError(f"at most {MAX_COLS} columns, got {len(cols)}.")
    if pad is not None and len(pad) != len(cols):
        raise ValueError(f"expected {len(cols)} pad values, got {len(pad)}.")
    for c in cols:
        if c.shape != mask.shape:
            raise ValueError(
                f"every column must have the mask's shape {tuple(mask.shape)}, "
                f"got {tuple(c.shape)}."
            )
        if c.element_size() != 4:
            raise TypeError(f"columns must hold 32-bit elements, got {c.dtype}.")


def stream_compact_plain(
    mask: torch.Tensor, cols: Sequence[torch.Tensor], pad: Pad = None
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Plain PyTorch compaction: ``nonzero`` finds the live rows (a host
    sync on CUDA) and ``index_select`` gathers them into outputs pre-filled
    with ``pad`` (or left unspecified past ``n_live`` without it)."""
    _check(mask, cols, pad)
    if pad is None:
        outs = [torch.empty_like(c) for c in cols]
    else:
        outs = [torch.full_like(c, p) for c, p in zip(cols, pad)]
    idx = torch.nonzero(mask).squeeze(1)
    k = idx.numel()
    for o, c in zip(outs, cols):
        o[:k] = c.index_select(0, idx)
    return outs, torch.tensor(k, dtype=torch.int32, device=mask.device)


def _pad_words(cols: Sequence[torch.Tensor], pad: Sequence[float]):
    """Each pad value as the raw 32-bit word of its column's dtype (numpy on
    the host: a CPU tensor per value costs more than the launch)."""
    words = [
        int(np.array(p, dtype=_NUMPY[c.dtype]).view(np.uint32)) for c, p in zip(cols, pad)
    ]
    return (ctypes.c_uint32 * MAX_COLS)(*words)


def _scratch_bytes(n: int, device: torch.device) -> int:
    """The launch's status words, ticket and count (none on the CPU)."""
    if device.type == "cpu" or not _build.loaded():
        return 0
    return (_build.library().tc_stream_compact_scratch(n) + 1) * 8


def _moved(mask: torch.Tensor, cols: Sequence[torch.Tensor]):
    """``(bytes_accessed, hbm_bytes)`` of one compaction: the mask and every
    column read once, every output row (the live rows and the padding the
    kernel writes past them) and the count written once; the launch's
    tensors are its arguments, its outputs and its scratch."""
    io = nbytes(mask, *cols) + nbytes(*cols)
    return io + 4, io + _scratch_bytes(mask.numel(), mask.device)


def _compact_cost(args, kwargs, out):
    """:func:`stream_compact`'s cost: no float adds."""
    return (0, *_moved(args[0], args[1]))


def _summary_cost(args, kwargs, out):
    """:func:`compact_summary_rows`'s cost: its one compaction's."""
    scores, tp, fp, keep = args
    return (0, *_moved(keep, (scores, tp, fp)))


@watched(name="stream_compact", cost=_compact_cost, counts_launches=True)
def stream_compact(
    mask: torch.Tensor, cols: Sequence[torch.Tensor], pad: Pad = None
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Stable compress-to-front of up to 7 columns of 32-bit elements where
    ``mask`` is nonzero. Returns fresh compacted columns of the input's
    length, whose rows past ``n_live`` hold ``pad[c]`` (unspecified without
    ``pad``), and ``n_live`` as an int32 device scalar.

    CPU tensors run :func:`stream_compact_plain`. CUDA tensors launch the
    kernel on PyTorch's current stream with no host sync (``n_live`` stays
    on the device; the kernel writes the padding itself) and count the
    launch (``jit.calls{entry=stream_compact}``)."""
    _check(mask, cols, pad)
    if _build.runs_plain(mask):
        return stream_compact_plain(mask, cols, pad)
    lib = _build.library()
    if mask.dtype != torch.bool:
        mask = mask != 0
    mask = mask.contiguous()
    cols = [c.contiguous() for c in cols]
    _build.require_cuda("stream_compact", mask, *cols)
    n = mask.numel()
    dev = mask.device
    # one allocation for the outputs (a row each) and one for the scratch
    # (per-tile status words and the tile ticket, zeroed by the kernel's
    # call) with n_live in its last word: each allocation costs host time
    # that a launch on a busy card would otherwise hide
    block = torch.empty((len(cols), n), dtype=torch.int32, device=dev)
    outs = [block[i].view(c.dtype) for i, c in enumerate(cols)]
    words = lib.tc_stream_compact_scratch(n)
    scratch = torch.empty(words + 1, dtype=torch.int64, device=dev)
    n_live = scratch[words:].view(torch.int32)[0]
    src = (ctypes.c_void_p * MAX_COLS)(*(c.data_ptr() for c in cols))
    dst = (ctypes.c_void_p * MAX_COLS)(*(o.data_ptr() for o in outs))
    words = None if pad is None else _pad_words(cols, pad)
    with torch.cuda.device(dev):
        err = lib.tc_stream_compact(
            mask.data_ptr(),
            n,
            src,
            dst,
            words,
            len(cols),
            scratch.data_ptr(),
            n_live.data_ptr(),
            _build.stream_of(mask),
        )
    _build.check(err, "stream_compact")
    count_launch("stream_compact", _compact_cost, (mask, cols), (outs, n_live))
    return outs, n_live

# rows past n_live: the JAX wrapper's where(live, ., (NaN, 0, 0))
_SUMMARY_PAD = (PAD_SCORE, 0, 0)


@watched(name="compact_summary_rows", cost=_summary_cost)
def compact_summary_rows(
    scores: torch.Tensor, tp: torch.Tensor, fp: torch.Tensor, keep: torch.Tensor
):
    """Compact kept (score, tp, fp) rows to the front, stable; rows past
    ``n_live`` become (NaN, 0, 0). Scores are float32 and counts int32; all
    three move as raw words in one launch. Returns ``(s, tp, fp, n_live)``
    with arrays the length of the input."""
    (s, tp_out, fp_out), n_live = stream_compact(keep, [scores, tp, fp], _SUMMARY_PAD)
    return s, tp_out, fp_out, n_live


def compact_summary_rows_plain(
    scores: torch.Tensor, tp: torch.Tensor, fp: torch.Tensor, keep: torch.Tensor
):
    """:func:`compact_summary_rows` on :func:`stream_compact_plain`."""
    (s, tp_out, fp_out), n_live = stream_compact_plain(
        keep, [scores, tp, fp], _SUMMARY_PAD
    )
    return s, tp_out, fp_out, n_live
