"""The port's kernel modules against the JAX package, on the CPU.

Each case feeds the same numpy inputs, made from a seed, to a function of
``torcheval_tpu_torch.ops`` (which runs the kernel's plain PyTorch version
for CPU tensors) and to its JAX counterpart. Where the JAX function reaches
a Pallas kernel it runs in interpret mode, as the JAX package's own tests run
it. Tolerances: counts and ``n_live`` exact; summary rows bit-equal, with
+0.0 and -0.0 counted as equal (JAX's sort canonicalises -0.0, so either
sign may survive as a tie group's score) and NaN matched by ``isnan``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.ops.confusion import class_counts as jax_class_counts
from torcheval_tpu.ops.stream_compact import stream_compact as jax_stream_compact
from torcheval_tpu.ops.summary import compact_counts as jax_compact_counts
from torcheval_tpu.ops.summary import compact_counts_fast as jax_compact_counts_fast
from torcheval_tpu_torch.ops.confusion import class_counts
from torcheval_tpu_torch.ops.curves import (
    binary_auprc_counts_kernel,
    binary_auprc_counts_presorted_kernel,
    binary_auprc_kernel,
    binary_auroc_counts_kernel,
    binary_auroc_counts_presorted_kernel,
    binary_auroc_kernel,
)
from torcheval_tpu_torch.ops.hist import hist, hist_plain
from torcheval_tpu_torch.ops.stream_compact import (
    compact_summary_rows,
    stream_compact,
    stream_compact_plain,
)
from torcheval_tpu_torch.ops.summary import compact_counts, compact_counts_fast

RTOL, ATOL = 1e-5, 1e-8


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- histogram
@pytest.mark.parametrize("num_classes", [1, 5, 1000, 1500])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_hist_plain_matches_pallas_hist(num_classes, dtype):
    rng = np.random.default_rng(num_classes)
    labels = rng.integers(-3, num_classes + 3, 3000).astype(dtype)  # out of range too
    want = np.asarray(
        jax_class_counts(jnp.asarray(labels, jnp.int32), num_classes, method="pallas")
    )
    got = hist_plain(_t(labels), num_classes)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(hist(_t(labels), num_classes).numpy(), want)


def test_hist_empty_and_rejects():
    assert hist(torch.zeros(0, dtype=torch.int64), 4).tolist() == [0, 0, 0, 0]
    with pytest.raises(TypeError):
        hist(torch.zeros(3, dtype=torch.float32), 4)
    with pytest.raises(ValueError):
        hist(torch.zeros((2, 2), dtype=torch.int64), 4)


@pytest.mark.parametrize("weighted", [False, True])
def test_class_counts_matches_jax(weighted):
    rng = np.random.default_rng(3)
    labels = rng.integers(-2, 12, 500)
    w = rng.random(500).astype(np.float32) if weighted else None
    want = np.asarray(
        jax_class_counts(
            jnp.asarray(labels, jnp.int32), 10, None if w is None else jnp.asarray(w)
        )
    )
    got = class_counts(_t(labels), 10, None if w is None else _t(w))
    assert got.dtype == (torch.float32 if weighted else torch.int32)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------- compaction
def _compact_case(name):
    """(mask, cols) of the JAX package's stream_compact test cases."""
    rng = np.random.default_rng(7)
    if name == "basic":
        mask = np.array([0, 1, 1, 0, 1] + [0] * 251, np.float32)
        return mask, [np.arange(256, dtype=np.float32)]
    if name == "dead_nan_inf":
        mask = np.zeros(256, np.float32)
        mask[:100] = 1
        col = np.full(256, np.nan, np.float32)
        col[:100] = np.arange(100)
        col[100:128] = np.inf
        return mask, [col]
    if name == "multi_column":
        mask = (rng.random(1000) < 0.6).astype(np.float32)
        return mask, [rng.random(1000).astype(np.float32) for _ in range(3)]
    if name == "multi_chunk":
        mask = (rng.random(16384) < 0.8).astype(np.float32)
        return mask, [rng.random(16384).astype(np.float32)]
    if name == "all_dead":
        return np.zeros(256, np.float32), [np.arange(256, dtype=np.float32)]
    if name == "all_live":
        return np.ones(256, np.float32), [np.arange(256, dtype=np.float32)]
    if name == "empty":
        return np.zeros(0, np.float32), [np.zeros(0, np.float32)]
    raise KeyError(name)


@pytest.mark.parametrize(
    "case",
    ["basic", "dead_nan_inf", "multi_column", "multi_chunk", "all_dead", "all_live", "empty"],
)
def test_stream_compact_plain_matches_jax(case):
    mask, cols = _compact_case(case)
    got, n_live = stream_compact_plain(_t(mask), [_t(c) for c in cols])
    if mask.size:
        want, want_n = jax_stream_compact(
            jnp.asarray(mask), [jnp.asarray(c) for c in cols], interpret=True
        )
        assert int(n_live) == int(want_n)
    else:
        want = cols
        assert int(n_live) == 0
    nl = int(n_live)
    assert nl == int((mask != 0).sum())
    assert n_live.dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[:nl], np.asarray(w)[:nl])
    # the wrapper takes the plain version for CPU tensors
    got2, n2 = stream_compact(_t(mask), [_t(c) for c in cols])
    assert int(n2) == nl
    for g, g2 in zip(got, got2):
        np.testing.assert_array_equal(g.numpy()[:nl], g2.numpy()[:nl])


@pytest.mark.parametrize("n_live", [1, 127, 128, 129, 255, 256, 300])
def test_compact_summary_rows_boundary_phases(n_live):
    rng = np.random.default_rng(n_live)
    n = 512
    s = np.full(n, np.nan, np.float32)
    s[:n_live] = -np.sort(-rng.random(n_live).astype(np.float32))
    s[n_live // 2] = -0.0
    tp = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    fp = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    keep = ~np.isnan(s)
    keep[::3] = False
    so, tpo, fpo, nl = compact_summary_rows(_t(s), _t(tp), _t(fp), _t(keep))
    k = int(keep.sum())
    assert int(nl) == k
    # raw words move bit for bit: -0.0 stays -0.0, padding is NaN
    np.testing.assert_array_equal(so.numpy()[:k].view(np.int32), s[keep].view(np.int32))
    assert np.isnan(so.numpy()[k:]).all()
    np.testing.assert_array_equal(tpo.numpy(), np.r_[tp[keep], np.zeros(n - k, np.int32)])
    np.testing.assert_array_equal(fpo.numpy(), np.r_[fp[keep], np.zeros(n - k, np.int32)])


def test_stream_compact_rejects_bad_columns():
    mask = torch.ones(8)
    with pytest.raises(ValueError, match="at most"):
        stream_compact(mask, [torch.zeros(8)] * 8)
    with pytest.raises(TypeError, match="32-bit"):
        stream_compact(mask, [torch.zeros(8, dtype=torch.float64)])
    with pytest.raises(ValueError, match="shape"):
        stream_compact(mask, [torch.zeros(9)])


# ------------------------------------------------------------------ summary
def _summary_case(name):
    rng = np.random.default_rng(11)
    if name == "ties":
        s = ((rng.random(4096) * 50).astype(np.int32) / 50.0).astype(np.float32)
        return s, rng.integers(0, 3, 4096), rng.integers(0, 3, 4096)
    if name == "inf":
        s = np.array([np.inf, 3.0, 0.5, -np.inf] * 16, np.float32)
        return s, np.ones(64), np.ones(64)
    if name == "nan_samples":
        s = np.array([0.9, np.nan, 0.4, np.nan, 0.1] * 8, np.float32)
        return s, np.ones(40), np.zeros(40)
    if name == "nan_padding":
        s = np.full(1024, np.nan, np.float32)
        s[:200] = np.sort(rng.random(200).astype(np.float32))[::-1]
        tp = np.zeros(1024)
        fp = np.zeros(1024)
        tp[:200] = rng.integers(0, 5, 200)
        fp[:200] = rng.integers(0, 5, 200)
        return s, tp, fp
    if name == "big_counts":
        s = np.repeat(np.linspace(1, 0, 8).astype(np.float32), 32)
        return s, np.full(256, 3_000_000 // 32), np.full(256, 123_456 // 32)
    if name == "signed_zeros":
        s = np.array([0.0, -0.0, 0.5, -0.0, 0.0, -0.5] * 20, np.float32)
        return s, rng.integers(0, 2, 120), rng.integers(0, 2, 120)
    if name == "empty":
        return np.zeros(0, np.float32), np.zeros(0), np.zeros(0)
    raise KeyError(name)


def _assert_summary_equal(got, want):
    gs, gtp, gfp, gn, gnan = (np.asarray(a) for a in got)
    ws, wtp, wfp, wn, wnan = (np.asarray(a) for a in want)
    assert int(gn) == int(wn) and int(gnan) == int(wnan)
    nl = int(wn)
    assert not np.isnan(gs[:nl]).any()
    assert np.isnan(gs[nl:]).all() and np.isnan(ws[nl:]).all()
    # bit-equal with +0.0 == -0.0: canonicalise zeros, then compare words
    g = np.where(gs[:nl] == 0, np.float32(0), gs[:nl]).view(np.int32)
    w = np.where(ws[:nl] == 0, np.float32(0), ws[:nl]).view(np.int32)
    np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(gtp, wtp)
    np.testing.assert_array_equal(gfp, wfp)


@pytest.mark.parametrize(
    "case", ["ties", "inf", "nan_samples", "nan_padding", "big_counts", "signed_zeros", "empty"]
)
@pytest.mark.parametrize("fast", [False, True])
def test_compact_counts_matches_jax(case, fast):
    s, tp, fp = _summary_case(case)
    tp, fp = tp.astype(np.int32), fp.astype(np.int32)
    want = jax_compact_counts(jnp.asarray(s), jnp.asarray(tp), jnp.asarray(fp))
    fn = compact_counts_fast if fast else compact_counts
    got = fn(_t(s), _t(tp), _t(fp))
    _assert_summary_equal(got, want)
    if fast and s.size:
        # and the JAX fast path (Pallas kernel, interpret mode) agrees too
        _assert_summary_equal(
            got,
            jax_compact_counts_fast(
                jnp.asarray(s), jnp.asarray(tp), jnp.asarray(fp), interpret=True
            ),
        )


# ------------------------------------------------------------------- curves
def test_curves_match_jax():
    import torcheval_tpu.ops.curves as jc

    rng = np.random.default_rng(5)
    x = ((rng.random(3000) * 300).astype(np.int32) / 300.0).astype(np.float32)
    x[:10] = -np.inf
    t = (rng.random(3000) < 0.4).astype(np.float32)
    for ours, theirs in (
        (binary_auroc_kernel, jc.binary_auroc_kernel),
        (binary_auprc_kernel, jc.binary_auprc_kernel),
    ):
        np.testing.assert_allclose(
            float(ours(_t(x), _t(t))), float(theirs(jnp.asarray(x), jnp.asarray(t))),
            rtol=RTOL, atol=ATOL,
        )
    s, tp, fp = x, rng.integers(0, 4, 3000).astype(np.int32), rng.integers(0, 4, 3000).astype(np.int32)
    summary = compact_counts(_t(s), _t(tp), _t(fp))[:3]
    jsummary = jax_compact_counts(jnp.asarray(s), jnp.asarray(tp), jnp.asarray(fp))[:3]
    for ours, theirs, args, jargs in (
        (binary_auroc_counts_kernel, jc.binary_auroc_counts_kernel, (s, tp, fp), None),
        (binary_auprc_counts_kernel, jc.binary_auprc_counts_kernel, (s, tp, fp), None),
        (binary_auroc_counts_presorted_kernel, jc.binary_auroc_counts_presorted_kernel, summary, jsummary),
        (binary_auprc_counts_presorted_kernel, jc.binary_auprc_counts_presorted_kernel, summary, jsummary),
    ):
        targs = [a if isinstance(a, torch.Tensor) else _t(a) for a in args]
        jargs = jargs if jargs is not None else [jnp.asarray(a) for a in args]
        np.testing.assert_allclose(
            float(ours(*targs)), float(theirs(*jargs)), rtol=RTOL, atol=ATOL
        )


def test_curves_degenerate_and_empty():
    e, z = torch.zeros(0), torch.zeros(0, dtype=torch.int32)
    assert float(binary_auroc_counts_presorted_kernel(e, z, z)) == 0.5
    assert float(binary_auprc_counts_presorted_kernel(e, z, z)) == 0.0
    assert float(binary_auprc_kernel(e, e)) == 0.0
    x = torch.rand(10)
    assert float(binary_auroc_kernel(x, torch.ones(10))) == 0.5
    assert float(binary_auprc_kernel(x, torch.zeros(10))) == 0.0
