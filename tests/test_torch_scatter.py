"""The port's segment scatter against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through
``torcheval_tpu.ops.scatter`` (``segment_scatter`` on its XLA route and
``pallas_segment_sum`` in interpret mode, the Pallas kernel run as the JAX
package's own tests run it) and ``torcheval_tpu_torch.ops.scatter`` (on CPU
tensors, where ``segment_sum`` runs its plain version). Integers and
integer-valued floats must match exactly. Float sums may differ by the
order of their adds: each side is within ``(count - 1) * 2^-24 * sum|v|``
of the exact sum per segment and lane (the module's stated bound), so the
two are held within twice that.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.ops.scatter import pallas_segment_sum
from torcheval_tpu.ops.scatter import segment_scatter as jax_segment_scatter
from torcheval_tpu_torch import _build
from torcheval_tpu_torch.ops.scatter import (
    score_segment_sum,
    segment_scatter,
    segment_sum,
    segment_sum_plain,
    segment_sum_route,
)
from torcheval_tpu_torch.utils.test_utils.obs_counts import count, launches, recording


@pytest.fixture
def obs_on():
    """The obs registry on (and reset) for a test that counts launches,
    folds or rounds: the registry is the port's one counter."""
    with recording():
        yield


_JAX_OPS = {
    "sum": jax.ops.segment_sum,
    "max": jax.ops.segment_max,
    "min": jax.ops.segment_min,
}


def _rows(rng, n, s):
    return rng.integers(-2, s + 3, n)  # out of range on both sides


def _ref_sum(vals, rows, s):
    out = np.zeros((s,) + vals.shape[1:], np.float64)
    for r, v in zip(rows, vals):
        if 0 <= r < s:
            out[r] += v
    return out


@pytest.mark.parametrize(
    "n,d,s",
    [(211, 3, 7), (1024, 128, 64), (37, 1, 513), (8, 130, 9), (300, 1, 1), (500, 3, 12_288)],
)
def test_sum_matches_pallas_interpret_and_xla(n, d, s):
    rng = np.random.default_rng(n + d + s)
    vals = rng.integers(0, 5, (n, d)).astype(np.float32)  # sums are exact in float32
    rows = _rows(rng, n, s)
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(rows), s).numpy()
    pallas = np.asarray(pallas_segment_sum(jnp.asarray(vals), jnp.asarray(rows), s, interpret=True))
    xla = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(rows), num_segments=s))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, _ref_sum(vals, rows, s))


@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32])
@pytest.mark.parametrize("d", [1, 3, 130])
def test_reduces_match_xla(reduce, dtype, d):
    rng = np.random.default_rng(d)
    n, s = 400, 37
    if np.issubdtype(dtype, np.integer):
        vals = rng.integers(-1000, 1000, (n, d)).astype(dtype)
    else:
        vals = rng.standard_normal((n, d)).astype(dtype)
    rows = _rows(rng, n, s)
    got = segment_scatter(torch.from_numpy(vals), torch.from_numpy(rows), s, reduce=reduce).numpy()
    # JAX runs 32-bit: an int64 column arrives as int32, with the same values
    want = np.asarray(
        jax_segment_scatter(jnp.asarray(vals), jnp.asarray(rows), s, reduce=reduce, method="xla")
    )
    assert got.dtype == dtype and got.shape == (s, d)
    if reduce != "sum" or not np.issubdtype(dtype, np.floating):
        np.testing.assert_array_equal(got, want)
        return
    count = np.bincount(rows[(rows >= 0) & (rows < s)], minlength=s)[:, None]
    mag = _ref_sum(np.abs(vals.astype(np.float64)), rows, s)
    bound = 2 * np.maximum(count - 1, 0) * 2.0**-24 * mag
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)
    assert np.all(np.abs(got.astype(np.float64) - _ref_sum(vals, rows, s)) <= bound / 2)


def test_nd_tail_and_int64_rows():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 9, (128, 3, 4)).astype(np.int32)
    rows = rng.integers(0, 11, 128)
    got = segment_scatter(torch.from_numpy(vals), torch.from_numpy(rows), 11)
    want = jax_segment_scatter(jnp.asarray(vals), jnp.asarray(rows), 11, method="pallas")
    assert got.dtype == torch.int32 and got.shape == (11, 3, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # int32 and int64 row columns give the same answer
    got32 = segment_scatter(torch.from_numpy(vals), torch.from_numpy(rows).int(), 11)
    assert torch.equal(got, got32)


@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
def test_empty_stream(reduce):
    got = segment_scatter(torch.zeros((0, 4)), torch.zeros(0, dtype=torch.int32), 6, reduce=reduce)
    want = jax_segment_scatter(jnp.zeros((0, 4)), jnp.zeros((0,), jnp.int32), 6, reduce=reduce)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if reduce == "sum":
        pallas = pallas_segment_sum(
            jnp.zeros((0, 4), jnp.float32), jnp.zeros((0,), jnp.int32), 6, interpret=True
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("reduce", ["sum", "max", "min"])
def test_nan_and_inf_propagate_as_in_jax(reduce):
    rng = np.random.default_rng(11)
    vals = rng.standard_normal((60, 2)).astype(np.float32)
    vals[3, 0] = np.nan
    vals[7, 1] = np.inf
    vals[9, 1] = -np.inf
    rows = rng.integers(0, 5, 60)
    got = segment_scatter(torch.from_numpy(vals), torch.from_numpy(rows), 5, reduce=reduce).numpy()
    want = np.asarray(_JAX_OPS[reduce](jnp.asarray(vals), jnp.asarray(rows), num_segments=5))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-6)


def test_methods_and_plain_version_agree_on_the_cpu(obs_on):
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(rng.integers(-50, 50, (300, 2)).astype(np.int64))
    rows = torch.from_numpy(rng.integers(-1, 40, 300))
    want = segment_sum_plain(vals, rows, 40)
    for method in ("auto", "kernel", "torch"):
        assert torch.equal(segment_scatter(vals, rows, 40, method=method), want)
    before = launches("segment_sum")
    segment_sum(vals, rows, 40)
    assert launches("segment_sum") == before  # the plain version launches nothing


def test_validation_errors():
    v = torch.zeros((4, 2))
    r = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="reduce must be"):
        segment_scatter(v, r, 3, reduce="mean")
    with pytest.raises(ValueError, match="method must be"):
        segment_scatter(v, r, 3, method="pallas")
    with pytest.raises(ValueError, match="sum.*only"):
        segment_scatter(v, r, 3, reduce="max", method="kernel")
    with pytest.raises(ValueError, match=r"vals \(N, \.\.\.\)"):
        segment_sum(torch.zeros((5, 2)), r, 3)
    with pytest.raises(TypeError, match="rows must be"):
        segment_sum(v, r.float(), 3)
    for bad in (torch.bool, torch.uint8, torch.int16):
        with pytest.raises(TypeError, match="int32, int64, float32, float64, bfloat16 or float16"):
            segment_sum(v.to(bad), r, 3)
    # half precision adds in its own type on the CPU (the JAX package's XLA route)
    assert segment_sum(v.to(torch.float16) + 1, r, 3).dtype == torch.float16


# (dtype, D, num_segments, route): each range's edges, and the main path's
# callers (the score sketch's binary fold, Quantile's value fold and its
# stacked fold of four, the multiclass fold, the splitter, the sliced
# window, the sharded tile)
_ROUTES = [
    (torch.int32, 2, 1, ("local", 1)),
    (torch.int32, 2, 2048, ("local", 1)),  # 16 KiB
    (torch.int32, 2, 2049, ("cluster", 2)),
    (torch.int32, 1, 4096, ("local", 1)),
    (torch.int32, 1, 4097, ("cluster", 2)),
    (torch.float32, 1, 8192, ("cluster", 2)),
    (torch.int32, 2, 32_768, ("cluster", 2)),  # 128 KiB a block
    (torch.int32, 2, 32_769, ("cluster", 4)),
    (torch.int32, 1, 1 << 16, ("cluster", 2)),  # the value fold
    (torch.int32, 2, 1 << 16, ("cluster", 4)),  # the binary score sketch
    (torch.float32, 2, (1 << 16) + 1, ("cluster", 8)),
    (torch.int32, 1, 4 << 16, ("cluster", 8)),  # Quantile's stacked fold, 1 MiB
    (torch.int32, 1, (4 << 16) + 1, ("head", 1)),
    (torch.int64, 2, 1 << 16, ("cluster", 8)),
    (torch.int64, 2, (1 << 16) + 1, ("head", 1)),
    (torch.float64, 130, 1008, ("cluster", 8)),
    (torch.float64, 130, 1009, ("head", 1)),
    (torch.int32, 40_000, 3, ("head", 1)),  # a row larger than a block's slice
    (torch.int32, 2, 1000 << 12, ("head", 1)),  # the multiclass fold
    (torch.int32, 1, 1000 << 16, ("head", 1)),  # the splitter
    (torch.int32, 2, 1_000_000, ("head", 1)),  # the sliced window
    (torch.int32, 2, 500_000, ("head", 1)),  # a sharded tile
]


@pytest.mark.parametrize("dtype,d,s,want", _ROUTES)
def test_segment_sum_route_by_output_size(dtype, d, s, want):
    assert segment_sum_route(dtype, d, s) == want


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 7, 130])
def test_segment_sum_route_ranges(dtype, d):
    """Over S from 1 past the cluster range: local up to 16 KiB, then the
    fewest blocks of 2, 4 or 8 whose 128 KiB slices hold whole rows, then
    head; each route's range is one interval, in that order."""
    row = d * dtype.itemsize
    per_block = 128 * 1024 // row
    seen = []
    for s in sorted({1, 2, 3, *range(1, 9 * per_block + 2, max(1, per_block // 7)),
                     *(k * per_block + e for k in (1, 2, 4, 8) for e in (-1, 0, 1))}):
        if s < 1:
            continue
        route, c = segment_sum_route(dtype, d, s)
        if s * row <= 16 * 1024:
            assert (route, c) == ("local", 1)
        elif s <= 8 * per_block:
            assert route == "cluster" and c in (2, 4, 8)
            assert -(-s // c) * row <= 128 * 1024
            assert c == 2 or -(-s // (c // 2)) * row > 128 * 1024
        else:
            assert (route, c) == ("head", 1)
        if not seen or seen[-1] != route:
            seen.append(route)
    assert seen == ["local", "cluster", "head"]


class _FakeKernels:
    """The kernels' library as ``segment_sum`` and ``score_segment_sum``
    call it: records each ``tc_segment_sum`` and ``tc_score_segment_sum``
    call and reports success."""

    def __init__(self):
        self.calls = []

    def tc_segment_sum(self, *args):
        self.calls.append(args)
        return 0

    def tc_score_segment_sum(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_kernels(monkeypatch):
    """The launch path with the library faked: the wrappers take CPU
    tensors for the card's and record what they would launch."""
    fake = _FakeKernels()
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return fake


@pytest.mark.parametrize("dtype,d,s,want", [
    (torch.int32, 2, 2048, ("local", 1)),
    (torch.int32, 2, 1 << 16, ("cluster", 4)),
    (torch.float32, 1, 4 << 16, ("cluster", 8)),
    (torch.bfloat16, 2, 1 << 16, ("cluster", 4)),  # launched as float32
    (torch.int64, 2, 1_000_000, ("head", 1)),
])
def test_segment_sum_passes_its_route_and_counts_it(fake_kernels, obs_on, dtype, d, s, want):
    """The wrapper's launch path with the library faked: the cluster size
    it passes to ``tc_segment_sum`` is the route rule's, and the launch
    counts one ``segment_sum.route{route=}`` of that route's name."""
    vals = torch.ones((64, d), dtype=dtype)
    rows = torch.arange(64)
    out = segment_sum(vals, rows, s)
    assert out.shape == (s, d) and out.dtype == dtype
    assert len(fake_kernels.calls) == 1 and fake_kernels.calls[0][7] == want[1]
    assert launches("segment_sum") == 1
    assert count("segment_sum.route") == 1 and count("segment_sum.route", route=want[0]) == 1


@pytest.mark.parametrize("bits,want", [
    (10, ("local", 1)),
    (11, ("local", 1)),
    (12, ("cluster", 2)),
    (16, ("cluster", 4)),
    (17, ("cluster", 8)),
    (18, ("head", 1)),
    (20, ("head", 1)),
])
def test_score_segment_sum_takes_the_int32_outputs_route(fake_kernels, obs_on, bits, want):
    """The fused score fold launches on the route the segment sum's rule
    gives its (2^bits, 2) int32 output, and counts that launch as the
    segment sum's, its route, its bytes (8 a row, the outputs once) and one
    ``sketch.fused_folds{kind=score}``."""
    assert segment_sum_route(torch.int32, 2, 1 << bits) == want
    scores, targets = torch.rand(64), (torch.rand(64) < 0.5).float()
    hist, nan = score_segment_sum(scores, targets, bits)
    assert hist.shape == (1 << bits, 2) and hist.dtype == nan.dtype == torch.int32
    assert nan.shape == () and not bool(hist.any()) and int(nan) == 0
    (call,) = fake_kernels.calls
    # target code, n, bits, cluster; the NaN word right after the counts
    assert (call[0], call[3], call[4], call[5]) == (2, 64, bits, want[1])
    assert call[7] == call[6] + (2 << bits) * 4
    assert launches("segment_sum") == 1
    assert count("segment_sum.route") == 1 and count("segment_sum.route", route=want[0]) == 1
    assert count("sketch.fused_folds") == 1 and count("sketch.fused_folds", kind="score") == 1
    assert count("obs.cost.launch_bytes", entry="segment_sum") == 64 * 8 + ((2 << bits) + 1) * 4


@pytest.mark.parametrize("sdtype", [torch.float32, torch.float16, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("tdtype,code", [
    (torch.float32, 2), (torch.int32, 0), (torch.int64, 0), (torch.bool, 0), (torch.float64, 0),
])
def test_score_segment_sum_reads_float32_scores_and_4_byte_targets(
    fake_kernels, monkeypatch, sdtype, tdtype, code
):
    """Scores reach the kernel as float32 and targets as float32 or int32
    (any other type cast to int32 first), contiguous, from unaligned views."""
    checked = []
    monkeypatch.setattr(_build, "require_cuda", lambda name, *ts: checked.append(ts))
    base_s = torch.rand(40).to(sdtype)
    base_t = (torch.rand(40) < 0.5).to(tdtype)
    score_segment_sum(base_s[3:], base_t[3:], 10)
    (call,) = fake_kernels.calls
    ((s, t),) = checked
    assert call[0] == code and call[3] == 37
    assert (call[1], call[2]) == (s.data_ptr(), t.data_ptr())
    assert s.dtype == torch.float32 and s.is_contiguous() and torch.equal(s, base_s[3:].float())
    assert t.dtype == (torch.float32 if code == 2 else torch.int32) and t.is_contiguous()
    assert torch.equal(t, base_t[3:].to(t.dtype))


def test_score_segment_sum_empty_and_misshapen(fake_kernels, obs_on):
    hist, nan = score_segment_sum(torch.zeros(0), torch.zeros(0), 16)
    assert hist.shape == (1 << 16, 2) and not bool(hist.any()) and int(nan) == 0
    assert fake_kernels.calls == [] and launches("segment_sum") == 0
    assert count("sketch.fused_folds") == 0
    with pytest.raises(ValueError, match="targets"):
        score_segment_sum(torch.zeros(4), torch.zeros(5), 16)
    with pytest.raises(ValueError, match="targets"):
        score_segment_sum(torch.zeros(2, 2), torch.zeros(2, 2), 16)
