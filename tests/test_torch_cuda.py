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


# csrc/hist.cu: the interleaved copies halve from 32 past C = 128, 256, 512,
# 1024 and 2048 (16 KB of copies);
# one class tile holds the opt-in shared memory's bins (58,112 on an H100),
# and more classes take a second tile
_HIST_EDGES = [1, 2, 5, 8, 9, 128, 129, 1024, 1025, 2048, 2049, 20_000, 58_112, 58_113, 120_000]


def _hist_case(labels, c):
    before = hist.launches
    got = hist(labels, c)
    torch.cuda.synchronize()
    assert hist.launches == before + 1
    assert torch.equal(got, hist_plain(labels, c))


@pytest.mark.parametrize("c", _HIST_EDGES)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_hist_kernel_at_copy_and_tile_edges(dev, c, dtype):
    g = torch.Generator(device=dev).manual_seed(c)
    _hist_case(torch.randint(-2, c + 2, (300_007,), generator=g, device=dev, dtype=dtype), c)


@pytest.mark.parametrize("c", [1, 5, 9, 1000])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_hist_kernel_every_label_equal(dev, c, dtype):
    # every lane of every warp on one bin
    _hist_case(torch.full((1 << 20,), c - 1, device=dev, dtype=dtype), c)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 7, 1001, 65_539])
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_hist_kernel_ragged_and_unaligned(dev, n, offset, dtype):
    # N not a multiple of the 16-byte vector, and views that start off a
    # 16-byte boundary (a scalar head before the vector body)
    g = torch.Generator(device=dev).manual_seed(n + offset)
    labels = torch.randint(-1, 1001, (n + offset,), generator=g, device=dev, dtype=dtype)[offset:]
    _hist_case(labels, 1000)


# below one tile of 4096 rows, one tile, ragged, and past 2^22 rows (over a
# thousand tiles looking back)
@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 4096, 4097, 300_001, (1 << 22) + 12_345])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_compaction_kernel_matches_plain(dev, n, density):
    g = torch.Generator(device=dev).manual_seed(n)
    s = torch.rand(n, generator=g, device=dev)
    s[::7] = float("nan")
    s[::11] = -0.0
    tp = torch.randint(0, 2**31 - 1, (n,), generator=g, device=dev, dtype=torch.int32)
    keep = torch.rand(n, generator=g, device=dev) < density
    before = stream_compact.launches
    got = compact_summary_rows(s, tp, tp.flip(0).contiguous(), keep)
    torch.cuda.synchronize()
    assert stream_compact.launches == before + 1
    want = compact_summary_rows_plain(s, tp, tp.flip(0).contiguous(), keep)
    assert int(got[3]) == int(want[3]) == int(keep.sum())
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    # pad=None: rows past n_live are left as allocated
    (a,), na = stream_compact(keep, [tp])
    (b,), nb = stream_compact_plain(keep, [tp])
    k = int(nb)
    assert int(na) == k and torch.equal(a[:k], b[:k])
    assert stream_compact.launches == before + 2


def test_compaction_kernel_takes_unaligned_columns_and_mask(dev):
    # views one element in: no 16-byte loads, the same answer
    g = torch.Generator(device=dev).manual_seed(5)
    n = 3 * 4096 + 77
    s = torch.rand(n + 1, generator=g, device=dev)[1:]
    keep = (torch.rand(n + 1, generator=g, device=dev) < 0.5)[1:]
    (a,), na = stream_compact(keep, [s], [float("nan")])
    (b,), nb = stream_compact_plain(keep, [s], [float("nan")])
    assert int(na) == int(nb) and torch.equal(a.view(torch.int32), b.view(torch.int32))


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


def _ideal_ranking_rows(n, l, g):
    """{0, 1} relevance at density 0.001, as the retrieval leg's ideal
    ranking sees it: almost all ties."""
    return (torch.rand((n, l), generator=g, device=g.device) < 0.001).to(torch.float32)


# one block a row up to 16384 columns, several blocks a row past it; the
# retrieval leg's (64, 10^6) at its k and the kernel's bound
@pytest.mark.parametrize(
    "n,l,k",
    [(5, 1, 1), (6, 1025, 1), (6, 1025, 128), (7, 4096, 5), (7, 4097, 128),
     (9, 10000, 5), (4, 12345, 128), (4, 128, 128), (4, 300_001, 100),
     (5, 16384, 5), (5, 16384, 128), (5, 16385, 5), (5, 16385, 128),
     (64, 1_000_000, 1), (64, 1_000_000, 10), (64, 1_000_000, 100), (64, 1_000_000, 128),
     (4, (1 << 21) + 5, 100)],
)
def test_topk_kernel_matches_plain_bit_for_bit(dev, n, l, k):
    g = torch.Generator(device=dev).manual_seed(l + k)
    for x in (torch.rand((n, l), generator=g, device=dev), _special_rows(n, l, g),
              _ideal_ranking_rows(n, l, g)):
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


@pytest.mark.parametrize("k", [1, 100, 128])
def test_topk_kernel_on_all_equal_long_rows(dev, k):
    # every value digit ties: the selection goes on through the index digits
    x = torch.full((8, 1_000_000), 0.25, device=dev)
    x[3, 999_999] = 0.5
    x[5, :7] = -0.0
    v, i = topk_kernel(x, k)
    pv, pi = topk_kernel_plain(x, k)
    dv, di = topk(x, k, method="dense")
    assert torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_segment_sum_half_precision_on_the_card(dev, dtype):
    """Half-precision values at the sliced leg's shape, (2^20, 2) into 10^6
    cohorts on power-law rows: one float32 launch, then each segment's sum
    rounded once to the half type. Within the module's bound of a float64
    sum: the float32 adds, (count - 1) * (2^-24 + 2^-53) * sum|v|, plus u of
    the half type times the float32 sum."""
    n, s = 1 << 20, 1_000_000
    rng = np.random.default_rng(11)
    vals = torch.from_numpy(rng.standard_normal((n, 2))).to(dev, dtype)
    rows = _rows("zipf", n, s, 11).to(dev, torch.int32)
    before = segment_sum.launches
    got = segment_sum(vals, rows, s)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    assert got.dtype == dtype and got.shape == (s, 2)
    ref = segment_sum_plain(vals.double(), rows, s)
    mag = segment_sum_plain(vals.double().abs(), rows, s)
    count = segment_sum_plain(torch.ones(n, dtype=torch.float64, device=dev), rows, s)[:, None]
    adds = (count - 1).clamp(min=0) * (2.0**-24 + 2.0**-53) * mag
    u = 2.0**-8 if dtype == torch.bfloat16 else 2.0**-11
    bound = adds + u * (ref.abs() + adds)
    assert bool(((got.double() - ref).abs() <= bound).all())


@pytest.mark.parametrize("kind", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", ["BinaryAUROC", "BinaryAUPRC"])
def test_half_precision_compacting_curves_on_the_card_equal_the_cpu(dev, name, kind):
    """The scores cast to float32 before the fold, then the compaction
    kernel; 3 batches of 300 (``default_rng(5)``) with threshold 100, as the
    half-precision parity tests run on the CPU. bfloat16 gives the JAX
    package's AUROC 0.48699 and AUPRC 0.51331."""
    from torcheval_tpu_torch import metrics as T

    dtype = getattr(torch, kind)
    rng = np.random.default_rng(5)
    scores = rng.random((3, 300)).astype(np.float32)
    targets = rng.integers(0, 2, (3, 300)).astype(np.float32)
    card = getattr(T, name)(compaction_threshold=100, device=dev)
    cpu = getattr(T, name)(compaction_threshold=100, device="cpu")
    before = stream_compact.launches
    for sc, t in zip(scores, targets):
        card.update(torch.tensor(sc).to(dtype).to(dev), torch.tensor(t).to(dev))
        cpu.update(torch.tensor(sc).to(dtype), torch.tensor(t))
    got = float(card.compute())
    assert stream_compact.launches - before >= 3
    assert got == pytest.approx(float(cpu.compute()), rel=1e-5)
    if kind == "bfloat16":
        want = 0.48699 if name == "BinaryAUROC" else 0.51331
        assert got == pytest.approx(want, abs=5e-6)


def _head_edges(d, size):
    """The rows csrc/scatter.cu privatises for D lanes of `size`-byte
    values at a large S: the first 64 rows in up to 32 copies within 16 KB
    (fewer rows where one copy does not fit), then single rows up to 32 KB.
    Returns (hot rows, head rows)."""
    row = d * size
    copies = 32
    while copies > 1 and 64 * row * copies > 16384:
        copies //= 2
    hot = 64 if 64 * row <= 16384 else 16384 // row
    return hot, hot + (32768 - hot * row * copies) // row


def _sum_vals(dtype, n, d, rng):
    if dtype.is_floating_point:
        vals = torch.from_numpy(rng.standard_normal((n, d)))
        vals[::97, 0] = float("nan")
        vals[1::89, -1] = float("inf")
        return vals.to(dtype)
    big = 2**31 - 1 if dtype == torch.int32 else 2**62
    return torch.from_numpy(rng.integers(-big, big, (n, d))).to(dtype)


def _sum_case(vals, rows, s):
    before = segment_sum.launches
    got = segment_sum(vals, rows, s)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 1
    _assert_sum_matches(got, vals, rows, s)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 2, 3, 7, 130])
@pytest.mark.parametrize("row_dtype", [torch.int32, torch.int64])
def test_segment_sum_kernel_every_row_zero(dev, dtype, d, row_dtype):
    # one cohort takes the whole batch
    n = 1 << 17 if d < 100 else 1 << 12
    vals = _sum_vals(dtype, n, d, np.random.default_rng(d)).to(dev)
    _sum_case(vals, torch.zeros(n, dtype=row_dtype, device=dev), 1000)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 2, 3, 7, 130])
@pytest.mark.parametrize("part", [0, 1])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_segment_sum_kernel_around_the_head(dev, dtype, d, part, edge):
    # S one row short of the copied (part 0) or the whole (part 1)
    # privatised head, the head exactly, one row past it
    s = _head_edges(d, torch.tensor([], dtype=dtype).element_size())[part] + edge
    n = 50_000 if d < 100 else 3_000
    rng = np.random.default_rng(s)
    vals = _sum_vals(dtype, n, d, rng).to(dev)
    rows = torch.from_numpy(rng.integers(-2, s + 2, n)).to(dev)
    for r in (rows, rows.to(torch.int32)):
        _sum_case(vals, r, s)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("shift", [(1, 0), (0, 1), (1, 1), (3, 2)])
def test_segment_sum_kernel_unaligned_views(dev, dtype, d, shift):
    # vals and rows views that start off a 16-byte boundary, alone or both
    vs, rs = shift
    n = 10_003
    rng = np.random.default_rng(d)
    vals = _sum_vals(dtype, n + vs, d, rng).to(dev)[vs:]
    rows = _rows("zipf", n + rs, 5000, d).to(dev, torch.int32)[rs:]
    _sum_case(vals, rows, 5000)
    _sum_case(vals, rows.to(torch.int64), 5000)


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


@pytest.mark.parametrize("n,c", [(1000, 7), ((1 << 18) + 1, 1 << 12), (1 << 22, 5)])
def test_match_triple_counts_on_the_card_is_two_histograms(dev, n, c):
    from torcheval_tpu_torch.ops.confusion import match_triple_counts

    g = torch.Generator(device=dev).manual_seed(n)
    pred = torch.randint(-2, c + 2, (n,), generator=g, device=dev)
    target = torch.where(torch.rand(n, generator=g, device=dev) < 0.3, pred,
                         torch.randint(-2, c + 2, (n,), generator=g, device=dev))
    before = hist.launches
    got = match_triple_counts(pred, target, c)
    torch.cuda.synchronize()
    assert hist.launches == before + 2
    for x, w in zip(got, match_triple_counts(pred.cpu(), target.cpu(), c)):
        assert x.dtype == torch.int32 and torch.equal(x.cpu(), w)


@pytest.mark.parametrize("average", ["micro", "macro", "weighted", None])
def test_f1_on_the_card_equals_the_cpu(dev, average):
    from torcheval_tpu_torch.metrics import MulticlassF1Score

    rng = np.random.default_rng(2)
    card = MulticlassF1Score(num_classes=5, average=average, device=dev)
    cpu = MulticlassF1Score(num_classes=5, average=average, device="cpu")
    for _ in range(3):
        scores = rng.random((4096, 5)).astype(np.float32)
        labels = rng.integers(0, 5, 4096)
        card.update(scores, labels)
        cpu.update(scores, labels)
    for name in ("num_tp", "num_label", "num_prediction"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
    assert torch.allclose(card.compute().cpu(), cpu.compute(), rtol=1e-5)


def test_sharded_class_counts_at_world_size_one_equal_hist(dev):
    from torcheval_tpu_torch.ops.hist import sharded_class_counts

    labels = torch.randint(-3, 12, (100_003,), device=dev)
    before = hist.launches
    got = sharded_class_counts(labels, 9)
    torch.cuda.synchronize()
    assert hist.launches == before + 1 and got.device == labels.device
    assert torch.equal(got.cpu(), hist_plain(labels.cpu(), 9))
