"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip
without one. Run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``
(``--noconftest``: ``tests/conftest.py`` sets up JAX, which the card's
machine need not have). ``chip_smoke.py`` repeats these checks at the main
path's full shapes.
"""

import numpy as np
import pytest
import torch

from torcheval_tpu_torch.ops.hist import hist, hist_plain
from torcheval_tpu_torch.ops.scatter import segment_scatter, segment_sum, segment_sum_plain
from torcheval_tpu_torch.ops.stream_compact import (
    compact_summary_rows,
    compact_summary_rows_plain,
    stream_compact,
    stream_compact_plain,
)
from torcheval_tpu_torch.ops.summary import compact_counts, compact_counts_fast
from torcheval_tpu_torch.metrics import (
    NDCG,
    BinaryAccuracy,
    Max,
    Mean,
    MulticlassAccuracy,
    ReciprocalRank,
    SlicedMetricCollection,
    TopKMultilabelAccuracy,
)
from torcheval_tpu_torch.ops.topk import topk, topk_kernel, topk_kernel_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,c", [(1, 1), (1000, 5), (100_000, 1000), (50_000, 20_000)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_hist_kernel_matches_plain(dev, n, c, dtype):
    g = torch.Generator(device=dev).manual_seed(n)
    labels = torch.randint(-2, c + 2, (n,), generator=g, device=dev, dtype=dtype)
    before = hist.launches
    got = hist(labels, c)
    torch.cuda.synchronize()
    assert hist.launches == before + 1
    assert torch.equal(got, hist_plain(labels, c))


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 300_001])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_compaction_kernel_matches_plain(dev, n, density):
    g = torch.Generator(device=dev).manual_seed(n)
    s = torch.rand(n, generator=g, device=dev)
    s[::7] = float("nan")
    s[::11] = -0.0
    tp = torch.randint(0, 2**31 - 1, (n,), generator=g, device=dev, dtype=torch.int32)
    keep = torch.rand(n, generator=g, device=dev) < density
    got = compact_summary_rows(s, tp, tp.flip(0).contiguous(), keep)
    want = compact_summary_rows_plain(s, tp, tp.flip(0).contiguous(), keep)
    assert int(got[3]) == int(want[3]) == int(keep.sum())
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    (a,), na = stream_compact(keep, [tp])
    (b,), nb = stream_compact_plain(keep, [tp])
    k = int(nb)
    assert int(na) == k and torch.equal(a[:k], b[:k])


def test_compact_counts_fast_matches_two_sorts(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    s = (torch.rand(1 << 16, generator=g, device=dev) * 64).floor() / 64
    s[::13] = float("nan")
    t = (torch.rand(1 << 16, generator=g, device=dev) < 0.4).to(torch.int32)
    a = compact_counts(s, t, 1 - t)
    b = compact_counts_fast(s, t, 1 - t)
    for i in range(1, 5):
        assert torch.equal(a[i], b[i])
    k = int(a[3])
    assert torch.equal(a[0][:k].view(torch.int32), b[0][:k].view(torch.int32))
    assert bool(torch.isnan(b[0][k:]).all())


def _special_rows(n, l, g):
    """Rows with heavy ties, all-equal rows and the float specials."""
    x = torch.randint(-3, 4, (n, l), generator=g, device=g.device).to(torch.float32)
    x[0] = 1.5  # all equal
    x[1, ::3] = float("nan")
    x[1, 1::3] = -float("nan")
    x[2, ::2] = -0.0
    x[2, 1::2] = 0.0
    x[3, ::5] = float("inf")
    x[3, 1::5] = float("-inf")
    return x


@pytest.mark.parametrize(
    "n,l,k",
    [(5, 1, 1), (6, 1025, 1), (6, 1025, 128), (7, 4096, 5), (7, 4097, 128),
     (9, 10000, 5), (4, 12345, 128), (4, 128, 128), (4, 300_001, 100)],
)
def test_topk_kernel_matches_plain_bit_for_bit(dev, n, l, k):
    g = torch.Generator(device=dev).manual_seed(l + k)
    for x in (torch.rand((n, l), generator=g, device=dev), _special_rows(n, l, g)):
        before = topk_kernel.launches
        v, i = topk_kernel(x, k)
        torch.cuda.synchronize()
        assert topk_kernel.launches == before + 1
        pv, pi = topk_kernel_plain(x, k)
        assert torch.equal(v.view(torch.int32), pv.view(torch.int32))
        assert torch.equal(i, pi)
        # the dense lowering (a stable sort) gives the same answer
        dv, di = topk(x, k, method="dense")
        assert torch.equal(v.view(torch.int32), dv.view(torch.int32)) and torch.equal(i, di)


def test_topk_auto_launches_the_kernel(dev):
    x = torch.rand((3, 2000), device=dev)
    before = topk_kernel.launches
    topk(x, 5)
    assert topk_kernel.launches == before + 1
    topk(x[:, :1000], 5)  # L <= 1024: dense
    topk(x, 129)  # k > 128: dense
    assert topk_kernel.launches == before + 1


@pytest.mark.parametrize("criteria", ["exact_match", "hamming", "overlap", "contain", "belong"])
def test_topk_multilabel_on_the_card_equals_the_cpu(dev, criteria):
    g = torch.Generator(device=dev).manual_seed(1)
    scores = (torch.rand((512, 3000), generator=g, device=dev) * 8).floor()  # ties
    target = (torch.rand((512, 3000), generator=g, device=dev) < 0.002).to(torch.int32)
    target[:, :4] = 1
    on_card = TopKMultilabelAccuracy(k=5, criteria=criteria, device=dev)
    on_cpu = TopKMultilabelAccuracy(k=5, criteria=criteria, device="cpu")
    before = topk_kernel.launches
    on_card.update(scores, target)
    on_cpu.update(scores.cpu(), target.cpu())
    assert topk_kernel.launches == before + 1
    assert int(on_card.num_correct) == int(on_cpu.num_correct)
    assert int(on_card.num_total) == int(on_cpu.num_total)


@pytest.mark.parametrize("k", [10, 100])
def test_ranking_on_the_card_equals_the_cpu(dev, k):
    g = torch.Generator(device=dev).manual_seed(k)
    scores = torch.rand((16, 50_000), generator=g, device=dev)
    rel = (torch.rand((16, 50_000), generator=g, device=dev) < 0.001).to(torch.float32)
    before = topk_kernel.launches
    on_card = NDCG(k=k, device=dev).update(scores, rel)
    assert topk_kernel.launches == before + 2  # the scores and the ideal ranking
    on_cpu = NDCG(k=k, device="cpu").update(scores.cpu(), rel.cpu())
    assert int(on_card.num_valid) == int(on_cpu.num_valid)
    assert torch.allclose(on_card.compute().cpu(), on_cpu.compute(), rtol=1e-5, atol=1e-8)
    tgt = torch.randint(0, 50_000, (16,), generator=g, device=dev)
    rr = ReciprocalRank(k=k, device=dev).update(scores, tgt).compute().cpu()
    assert torch.equal(rr, ReciprocalRank(k=k, device="cpu").update(scores.cpu(), tgt.cpu()).compute())


def _rows(kind, n, s, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        r = rng.integers(0, s, n)
    elif kind == "zipf":
        r = (rng.zipf(1.3, n) - 1) % s
    else:  # out of range on both sides
        r = rng.integers(-3, s + 3, n)
    return torch.from_numpy(r)


def _assert_sum_matches(got, vals, rows, s):
    """Integers exactly equal to the plain version; floats within the
    module's bound, (count - 1) * u * sum|v| per segment and lane, of a
    float64 reference (plus the reference's own bound), with NaN and
    infinities where the reference has them."""
    want = segment_sum_plain(vals, rows, s)
    assert got.dtype == vals.dtype and got.shape == want.shape
    if not vals.dtype.is_floating_point:
        assert torch.equal(got, want)
        return
    ref = segment_sum_plain(vals.double(), rows, s)
    mag = segment_sum_plain(vals.double().abs(), rows, s)
    count = segment_sum_plain(torch.ones_like(rows, dtype=torch.float64), rows, s)
    count = count.reshape(count.shape + (1,) * (vals.ndim - 1))
    u = 2.0**-24 if vals.dtype == torch.float32 else 2.0**-53
    # the float64 reference itself errs by up to (count - 1) * 2^-53 * sum|v|
    bound = (count - 1).clamp(min=0) * (u + 2.0**-53) * mag
    got = got.double()
    finite = torch.isfinite(ref)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(got[torch.isinf(ref)], ref[torch.isinf(ref)])
    assert bool(((got - ref).abs()[finite] <= bound[finite] + 1e-300).all())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 2, 7, 130])
@pytest.mark.parametrize("s,kind", [(1, "uniform"), (12_288, "zipf"), (2**20 + 3, "out_of_range")])
def test_segment_sum_kernel_matches_plain(dev, dtype, d, s, kind):
    n = 20_000 if d < 100 else 3_000
    rng = np.random.default_rng(d + s)
    rows = _rows(kind, n, s, d).to(dev)
    if dtype.is_floating_point:
        vals = torch.from_numpy(rng.standard_normal((n, d))).to(dev, dtype)
        vals[::97, 0] = float("nan")
        vals[1::89, -1] = float("inf")
        vals[2::83, -1] = float("-inf")
    else:
        big = 2**31 - 1 if dtype == torch.int32 else 2**62
        vals = torch.from_numpy(rng.integers(-big, big, (n, d))).to(dev, dtype)  # wraps
    for r in (rows, rows.to(torch.int32)):
        before = segment_sum.launches
        got = segment_sum(vals, r, s)
        torch.cuda.synchronize()
        assert segment_sum.launches == before + 1
        _assert_sum_matches(got, vals, r, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("s", [1, 12_288])
def test_segment_sum_kernel_exact_where_partial_sums_are(dev, dtype, s):
    # multiples of 1/4 below 2 on power-law rows: every partial sum stays
    # under 2^24 quarters, so any order of adds gives the exact sum
    rng = np.random.default_rng(s)
    n = 1 << 18
    vals = torch.from_numpy(rng.integers(0, 8, (n, 2)) / 4).to(dev, dtype)
    rows = _rows("zipf", n, s, 2).to(dev)
    assert torch.equal(segment_sum(vals, rows, s), segment_sum_plain(vals, rows, s))


def test_segment_sum_empty_and_tail_shape(dev):
    before = segment_sum.launches
    out = segment_sum(torch.zeros((0, 3), device=dev), torch.zeros(0, dtype=torch.int32, device=dev), 5)
    assert torch.equal(out, torch.zeros((5, 3), device=dev)) and segment_sum.launches == before
    vals = torch.randint(0, 9, (500, 3, 4), device=dev, dtype=torch.int32)
    rows = torch.randint(-1, 12, (500,), device=dev)
    got = segment_scatter(vals, rows, 11)
    assert segment_sum.launches == before + 1
    assert torch.equal(got, segment_sum_plain(vals, rows, 11))


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_segment_extrema_on_the_card_equal_the_cpu(dev, reduce):
    g = torch.Generator(device=dev).manual_seed(3)
    vals = torch.randn((4000, 2), generator=g, device=dev)
    vals[::101, 1] = float("nan")
    rows = torch.randint(-2, 40, (4000,), generator=g, device=dev)
    got = segment_scatter(vals, rows, 37, reduce=reduce)
    want = segment_scatter(vals.cpu(), rows.cpu(), 37, reduce=reduce)
    assert torch.equal(torch.isnan(got.cpu()), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got.cpu()), torch.nan_to_num(want))


def test_sliced_collections_on_the_card_equal_the_cpu(dev):
    rng = np.random.default_rng(0)

    def make(device):
        return (
            SlicedMetricCollection({"acc": BinaryAccuracy(device=device)}, capacity=8),
            SlicedMetricCollection({"mean": Mean(device=device), "max": Max(device=device)}, capacity=8),
            SlicedMetricCollection(
                {"macro": MulticlassAccuracy(average="macro", num_classes=5, device=device)}, capacity=8
            ),
        )

    card, cpu = make(dev), make("cpu")
    before = segment_sum.launches
    for _ in range(3):
        ids = (rng.zipf(1.3, 5000) - 1) % 300 * 7919 + 13
        s = rng.random(5000).astype(np.float32)
        t = (rng.random(5000) < 0.4).astype(np.float32)
        scores = rng.random((5000, 5)).astype(np.float32)
        labels = rng.integers(0, 5, 5000)
        for acc, agg, macro in (card, cpu):
            acc.update(ids, s, t)
            agg.update(ids, s)
            macro.update(ids, scores, labels)
    assert segment_sum.launches > before
    for got_col, want_col in zip(card, cpu):
        got, want = got_col.compute(), want_col.compute()
        for key in got:
            np.testing.assert_array_equal(got[key].slice_ids, want[key].slice_ids)
            g, w = got[key]["values"].cpu(), want[key]["values"]
            if key in ("mean", "macro"):  # float sums in another order
                assert torch.allclose(g, w, rtol=1e-5)
            else:
                assert torch.equal(g, w), key
        for name, member in got_col.metrics.items():
            for state, value in member.state_dict().items():
                if not value.dtype.is_floating_point:
                    assert torch.equal(value.cpu(), want_col.metrics[name].state_dict()[state])


def test_sliced_macro_accuracy_at_many_classes_equals_the_cpu(dev):
    # the per-class fold of 2^16 samples over 1000 classes scatters into
    # 2^16 * 1000 combined segments through the segment-sum kernel
    rng = np.random.default_rng(1)
    n, c = 2**16, 1000
    ids = rng.integers(0, 5000, n) * 7919 + 13
    scores = rng.random((n, c)).astype(np.float32)
    labels = rng.integers(0, c, n)
    cols = {}
    for device in (dev, "cpu"):
        col = SlicedMetricCollection(
            {"macro": MulticlassAccuracy(average="macro", num_classes=c, device=device)}, capacity=64
        )
        before = segment_sum.launches
        col.update(ids, torch.from_numpy(scores).to(device), torch.from_numpy(labels).to(device))
        if device == dev:
            assert segment_sum.launches > before
        cols[device] = col
    got, want = cols[dev].compute()["macro"], cols["cpu"].compute()["macro"]
    np.testing.assert_array_equal(got.slice_ids, want.slice_ids)
    for state, value in cols[dev].metrics["macro"].state_dict().items():
        want_state = cols["cpu"].metrics["macro"].state_dict()[state]
        if value.dtype.is_floating_point:
            assert torch.allclose(value.cpu(), want_state, rtol=1e-5), state
        else:
            assert torch.equal(value.cpu(), want_state), state
    assert torch.allclose(got["values"].cpu(), want["values"], rtol=1e-5, equal_nan=True)
