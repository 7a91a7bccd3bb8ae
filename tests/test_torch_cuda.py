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
from torcheval_tpu_torch.ops.scatter import (
    segment_scatter,
    segment_sum,
    segment_sum_plain,
    segment_sum_route,
)
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
from torcheval_tpu_torch.sketch import bucket_index
from torcheval_tpu_torch.utils.test_utils.obs_counts import count, launches, recording

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _obs_on():
    """A kernel's launches are its ``jit.calls{entry=}`` in the obs
    registry, which counts while it is enabled."""
    with recording():
        yield


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
    before = launches("hist")
    got = hist(labels, c)
    torch.cuda.synchronize()
    assert launches("hist") == before + 1
    assert torch.equal(got, hist_plain(labels, c))


# csrc/hist.cu: the interleaved copies halve from 32 past C = 128, 256, 512,
# 1024 and 2048 (16 KB of copies);
# one class tile holds the opt-in shared memory's bins (58,112 on an H100),
# and more classes take a second tile
_HIST_EDGES = [1, 2, 5, 8, 9, 128, 129, 1024, 1025, 2048, 2049, 20_000, 58_112, 58_113, 120_000]


def _hist_case(labels, c):
    before = launches("hist")
    got = hist(labels, c)
    torch.cuda.synchronize()
    assert launches("hist") == before + 1
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
    before = launches("stream_compact")
    got = compact_summary_rows(s, tp, tp.flip(0).contiguous(), keep)
    torch.cuda.synchronize()
    assert launches("stream_compact") == before + 1
    want = compact_summary_rows_plain(s, tp, tp.flip(0).contiguous(), keep)
    assert int(got[3]) == int(want[3]) == int(keep.sum())
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    # pad=None: rows past n_live are left as allocated
    (a,), na = stream_compact(keep, [tp])
    (b,), nb = stream_compact_plain(keep, [tp])
    k = int(nb)
    assert int(na) == k and torch.equal(a[:k], b[:k])
    assert launches("stream_compact") == before + 2


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
        before = launches("topk_kernel")
        v, i = topk_kernel(x, k)
        torch.cuda.synchronize()
        assert launches("topk_kernel") == before + 1
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
    before = launches("topk_kernel")
    topk(x, 5)
    assert launches("topk_kernel") == before + 1
    topk(x[:, :1000], 5)  # L <= 1024: dense
    topk(x, 129)  # k > 128: dense
    assert launches("topk_kernel") == before + 1


@pytest.mark.parametrize("criteria", ["exact_match", "hamming", "overlap", "contain", "belong"])
def test_topk_multilabel_on_the_card_equals_the_cpu(dev, criteria):
    g = torch.Generator(device=dev).manual_seed(1)
    scores = (torch.rand((512, 3000), generator=g, device=dev) * 8).floor()  # ties
    target = (torch.rand((512, 3000), generator=g, device=dev) < 0.002).to(torch.int32)
    target[:, :4] = 1
    on_card = TopKMultilabelAccuracy(k=5, criteria=criteria, device=dev)
    on_cpu = TopKMultilabelAccuracy(k=5, criteria=criteria, device="cpu")
    before = launches("topk_kernel")
    on_card.update(scores, target)
    on_cpu.update(scores.cpu(), target.cpu())
    card_sd, cpu_sd = on_card.state_dict(), on_cpu.state_dict()  # the deferred folds
    assert launches("topk_kernel") == before + 1
    assert int(card_sd["num_correct"]) == int(cpu_sd["num_correct"])
    assert int(card_sd["num_total"]) == int(cpu_sd["num_total"])


@pytest.mark.parametrize("k", [10, 100])
def test_ranking_on_the_card_equals_the_cpu(dev, k):
    g = torch.Generator(device=dev).manual_seed(k)
    scores = torch.rand((16, 50_000), generator=g, device=dev)
    rel = (torch.rand((16, 50_000), generator=g, device=dev) < 0.001).to(torch.float32)
    before = launches("topk_kernel")
    on_card = NDCG(k=k, device=dev).update(scores, rel)
    card_valid = int(on_card.state_dict()["num_valid"])  # the deferred fold
    assert launches("topk_kernel") == before + 2  # the scores and the ideal ranking
    on_cpu = NDCG(k=k, device="cpu").update(scores.cpu(), rel.cpu())
    assert card_valid == int(on_cpu.state_dict()["num_valid"])
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
    elif kind == "sketch":
        # 16-bit bucket ids of CTR-like logits, N(-3.89, 1): a band of some
        # thousands of buckets around id 16,300, far past any head
        logits = torch.from_numpy(rng.standard_normal(n).astype(np.float32) - 3.89)
        return bucket_index(logits, 16).to(torch.int64) % s
    elif kind == "hottest":
        # a third of the rows on one row in the middle, the rest uniform
        r = np.where(rng.random(n) < 1 / 3, s // 2 + 7, rng.integers(0, s, n))
    elif kind == "edges":
        # the rows at and just outside both ends
        r = rng.choice(np.array([-1, 0, s - 1, s]), n)
    else:  # out of range on both sides
        r = rng.integers(-3, s + 3, n)
    return torch.from_numpy(r)


def _cluster_capacity(dtype, d):
    """The most segments of D lanes of ``dtype`` the cluster route takes:
    8 blocks of 128 KiB, whole rows a block."""
    return 8 * (128 * 1024 // (d * torch.tensor([], dtype=dtype).element_size()))


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
@pytest.mark.parametrize("d", [1, 2, 4, 7, 130])
@pytest.mark.parametrize(
    "s,kind",
    [
        (1, "uniform"),
        (12_288, "zipf"),
        (2**20 + 3, "out_of_range"),
        (1 << 16, "sketch"),
        (1 << 16, "hottest"),
        (1 << 16, "edges"),
        ("capacity", "uniform"),
        ("capacity + 1", "uniform"),
    ],
)
def test_segment_sum_kernel_matches_plain(dev, dtype, d, s, kind):
    # every route (segment_sum_route); at the cluster route's capacity and
    # one row past it, where the head route takes over
    if s == "capacity":
        s = _cluster_capacity(dtype, d)
        assert segment_sum_route(dtype, d, s) == ("cluster", 8)
    elif s == "capacity + 1":
        s = _cluster_capacity(dtype, d) + 1
        assert segment_sum_route(dtype, d, s)[0] == "head"
    route = segment_sum_route(dtype, d, s)[0]
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
        before = launches("segment_sum"), count("segment_sum.route", route=route)
        got = segment_sum(vals, r, s)
        torch.cuda.synchronize()
        assert (launches("segment_sum"), count("segment_sum.route", route=route)) == (
            before[0] + 1, before[1] + 1)
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
    before = launches("segment_sum")
    got = segment_sum(vals, rows, s)
    torch.cuda.synchronize()
    assert launches("segment_sum") == before + 1
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
    before = launches("stream_compact")
    for sc, t in zip(scores, targets):
        card.update(torch.tensor(sc).to(dtype).to(dev), torch.tensor(t).to(dev))
        cpu.update(torch.tensor(sc).to(dtype), torch.tensor(t))
    got = float(card.compute())
    assert launches("stream_compact") - before >= 3
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
    before = launches("segment_sum")
    got = segment_sum(vals, rows, s)
    torch.cuda.synchronize()
    assert launches("segment_sum") == before + 1
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
    # privatised head, the head exactly, one row past it (the local or the
    # cluster route); then, at an S past the cluster route's capacity (the
    # head route), rows around that edge of the head
    e = _head_edges(d, torch.tensor([], dtype=dtype).element_size())[part] + edge
    n = 50_000 if d < 100 else 3_000
    rng = np.random.default_rng(e)
    vals = _sum_vals(dtype, n, d, rng).to(dev)
    big = _cluster_capacity(dtype, d) + 1
    assert segment_sum_route(dtype, d, big)[0] == "head"
    for s, rows in ((e, rng.integers(-2, e + 2, n)),
                    (big, np.where(rng.random(n) < 0.5, rng.integers(e - 3, e + 3, n),
                                   rng.integers(-2, big + 2, n)))):
        rows = torch.from_numpy(rows).to(dev)
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
    before = launches("segment_sum")
    out = segment_sum(torch.zeros((0, 3), device=dev), torch.zeros(0, dtype=torch.int32, device=dev), 5)
    assert torch.equal(out, torch.zeros((5, 3), device=dev)) and launches("segment_sum") == before
    vals = torch.randint(0, 9, (500, 3, 4), device=dev, dtype=torch.int32)
    rows = torch.randint(-1, 12, (500,), device=dev)
    got = segment_scatter(vals, rows, 11)
    assert launches("segment_sum") == before + 1
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
    before = launches("segment_sum")
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
    assert launches("segment_sum") == before  # deferred to the windows' folds
    for got_col, want_col in zip(card, cpu):
        got, want = got_col.compute(), want_col.compute()
        assert launches("segment_sum") > before
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
        before = launches("segment_sum")
        col.update(ids, torch.from_numpy(scores).to(device), torch.from_numpy(labels).to(device))
        col.state_dicts()  # the window's fold
        if device == dev:
            assert launches("segment_sum") > before
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
    before = launches("hist")
    got = match_triple_counts(pred, target, c)
    torch.cuda.synchronize()
    assert launches("hist") == before + 2
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
    card_sd, cpu_sd = card.state_dict(), cpu.state_dict()
    for name in ("num_tp", "num_label", "num_prediction"):
        assert torch.equal(card_sd[name].cpu(), cpu_sd[name])
    assert torch.allclose(card.compute().cpu(), cpu.compute(), rtol=1e-5)


def test_sharded_class_counts_at_world_size_one_equal_hist(dev):
    from torcheval_tpu_torch.ops.hist import sharded_class_counts

    labels = torch.randint(-3, 12, (100_003,), device=dev)
    before = launches("hist")
    got = sharded_class_counts(labels, 9)
    torch.cuda.synchronize()
    assert launches("hist") == before + 1 and got.device == labels.device
    assert torch.equal(got.cpu(), hist_plain(labels.cpu(), 9))


# ------------------------------------------------------------------ windows
def test_window_step_on_the_card_equals_the_cpu(dev):
    """A collection's window of 20 batches, folded in one window step: the
    counts exactly, the values within rtol 1e-5; F1's concat fold is two
    histogram launches for the whole window."""
    from torcheval_tpu_torch.metrics import MetricCollection, MulticlassF1Score

    rng = np.random.default_rng(3)
    batches = [(rng.random((2048, 5)).astype(np.float32), rng.integers(0, 5, 2048)) for _ in range(20)]

    def make(device):
        return MetricCollection({
            "acc": MulticlassAccuracy(num_classes=5, device=device),
            "macro": MulticlassAccuracy(average="macro", num_classes=5, device=device),
            "f1": MulticlassF1Score(num_classes=5, average="macro", device=device),
        })

    card, cpu = make(dev), make("cpu")
    for scores, labels in batches:
        card.update(torch.from_numpy(scores).to(dev), torch.from_numpy(labels).to(dev))
        cpu.update(scores, labels)
    assert len(card._window.chunks) == len(cpu._window.chunks) == 20
    hists, steps = launches("hist"), count("deferred.window_steps")
    got, want = card.compute(), cpu.compute()
    torch.cuda.synchronize()
    assert count("deferred.window_steps") == steps + 2
    # F1's two over the window (the stacked macro accuracy's counts run the
    # class counts' vmap rule, a segment sum)
    assert launches("hist") == hists + 2
    for name in got:
        assert torch.allclose(got[name].cpu(), want[name], rtol=1e-5, atol=1e-8), name
        for state, value in card[name].state_dict().items():
            assert torch.equal(value.cpu(), cpu[name].state_dict()[state]), (name, state)


def test_ndcg_window_on_the_card_equals_the_cpu(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    card, cpu = NDCG(k=10, device=dev), NDCG(k=10, device="cpu")
    for _ in range(3):
        scores = torch.rand((16, 20_000), generator=g, device=dev)
        rel = (torch.rand((16, 20_000), generator=g, device=dev) < 0.002).to(torch.float32)
        card.update(scores, rel)
        cpu.update(scores.cpu(), rel.cpu())
    before = launches("topk_kernel")
    got = card.compute()
    assert launches("topk_kernel") == before + 6  # the batches fold one by one
    assert int(card.num_valid) == int(cpu.state_dict()["num_valid"])
    assert torch.allclose(got.cpu(), cpu.compute(), rtol=1e-5, atol=1e-8)


def test_sliced_window_is_one_segment_sum_per_group_on_the_card(dev):
    rng = np.random.default_rng(5)
    stream = [((rng.zipf(1.3, 4096) - 1) % 500 * 7919 + 13, rng.random(4096).astype(np.float32),
               (rng.random(4096) < 0.4).astype(np.float32)) for _ in range(6)]
    card = SlicedMetricCollection({"acc": BinaryAccuracy(device=dev), "mean": Mean(device=dev)}, capacity=1024)
    cpu = SlicedMetricCollection({"acc": BinaryAccuracy(device="cpu"), "mean": Mean(device="cpu")}, capacity=1024)
    for ids, s, t in stream:
        card.update(ids, torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev))
        cpu.update(ids, s, t)
    before = launches("segment_sum")
    got, want = card.compute(), cpu.compute()
    # the accuracy's (N, 2) int32 pair; the Mean's (N, 1) float32 delta pair
    # is a (weighted_sum, weights) group of one shape and type
    assert launches("segment_sum") == before + 2
    for key in got:
        np.testing.assert_array_equal(got[key].slice_ids, want[key].slice_ids)
        assert torch.allclose(got[key]["values"].cpu(), want[key]["values"], rtol=1e-5)


@pytest.mark.parametrize("budget", ["chunks", "bytes"])
def test_valve_fires_at_the_same_batch_on_the_card_as_on_the_cpu(dev, budget):
    from torcheval_tpu_torch.metrics import MetricCollection

    rng = np.random.default_rng(6)
    x, t = rng.random((512, 5)).astype(np.float32), rng.integers(0, 5, 512)

    def lengths(device):
        col = MetricCollection(MulticlassAccuracy(num_classes=5, device=device))
        member = col["metric"]
        if budget == "chunks":
            member._DEFER_MAX_CHUNKS = 3
        else:
            member._DEFER_BUDGET_BYTES = 3 * (x.nbytes + t.nbytes)
        seen = []
        for _ in range(10):
            col.update(torch.from_numpy(x).to(device), torch.from_numpy(t).to(device))
            seen.append(len(col._window.chunks))
        return seen, float(col.compute())

    card, cpu = lengths(dev), lengths("cpu")
    assert card[0] == cpu[0] == [1, 2, 0] * 3 + [1]
    assert card[1] == cpu[1]


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_segment_sum_at_the_sliced_window_shape(dev, dtype):
    """The sliced leg's window: 2^24 rows of (N, 2) deltas into 10^6
    cohorts, power-law rows."""
    n, s = 1 << 24, 1_000_000
    g = torch.Generator(device=dev).manual_seed(7)
    rows = ((torch.rand(n, generator=g, device=dev) ** 4) * s).to(torch.int32)
    if dtype == torch.int32:
        vals = torch.randint(0, 2, (n, 2), generator=g, device=dev, dtype=torch.int32)
    else:
        vals = torch.rand((n, 2), generator=g, device=dev)
    got = segment_sum(vals, rows, s)
    want = segment_sum_plain(vals, rows, s)
    if dtype == torch.int32:
        assert torch.equal(got, want)
    else:
        count = torch.bincount(rows.to(torch.int64), minlength=s).to(torch.float64)[:, None]
        mag = segment_sum_plain(vals.abs().to(torch.float64), rows, s)
        bound = count * 2.0**-24 * mag  # the float32 summation bound, per cohort
        assert bool(((got.double() - want.double()).abs() <= 2 * bound + 1e-30).all())


def test_hist_at_the_small_batch_window_shape(dev):
    """F1's window of 200 batches of 8192 labels: 1,638,400 labels, 10 bins."""
    g = torch.Generator(device=dev).manual_seed(8)
    labels = torch.randint(-1, 11, (200 * 8192,), generator=g, device=dev)
    before = launches("hist")
    got = hist(labels, 10)
    torch.cuda.synchronize()
    assert launches("hist") == before + 1
    assert torch.equal(got, hist_plain(labels, 10))


# ------------------------------- precision, recall, confusion and curves
def test_confusion_matrix_at_1000_classes_equals_bincount(dev):
    from torcheval_tpu_torch.metrics import MulticlassConfusionMatrix
    from torcheval_tpu_torch.ops.confusion import confusion_matrix_counts

    g = torch.Generator(device=dev).manual_seed(3)
    c = 1000
    pred = torch.randint(0, c, (300_000,), generator=g, device=dev, dtype=torch.int32)
    target = torch.randint(0, c, (300_000,), generator=g, device=dev, dtype=torch.int32)
    pred[:7] = torch.tensor([-1, c, 5, 0, c + 3, -4, 9], device=dev, dtype=torch.int32)
    want = torch.bincount(
        (target.long() * c + pred.long())[(pred >= 0) & (pred < c)], minlength=c * c
    ).reshape(c, c)
    before = launches("hist")
    got = confusion_matrix_counts(pred, target, c)
    torch.cuda.synchronize()
    assert launches("hist") == before + 1 and got.dtype == torch.int32
    assert torch.equal(got.long(), want)
    m = MulticlassConfusionMatrix(c, device=dev)
    for i in range(3):
        m.update(pred[i * 100_000:(i + 1) * 100_000], target[i * 100_000:(i + 1) * 100_000])
    assert torch.equal(m.compute().long(), want)


@pytest.mark.parametrize("spec", [11, [0.0, 0.0, 0.5, 0.5, 1.0]])
def test_binned_curves_on_the_card_equal_the_cpu(dev, spec):
    from torcheval_tpu_torch.metrics import (
        BinaryBinnedPrecisionRecallCurve,
        MulticlassBinnedPrecisionRecallCurve,
    )

    g = torch.Generator().manual_seed(4)
    batches = []
    for _ in range(4):  # a stacked window: the vmapped fold on the segment sum
        x = (torch.randint(-1, 10, (2000, 7), generator=g) / 8).float()
        x[0, 0], x[1, 1], x[2, 2], x[3, 3] = float("nan"), float("inf"), -0.0, float("-inf")
        batches.append((x, torch.randint(0, 7, (2000,), generator=g)))

    def binary(device):
        m = BinaryBinnedPrecisionRecallCurve(threshold=spec, device=device)
        for x, t in batches:
            m.update(x[:, 0].contiguous().to(device), (t == 0).to(torch.int32).to(device))
        return m.state_dict()

    before = launches("segment_sum")
    mc_card = MulticlassBinnedPrecisionRecallCurve(7, threshold=spec, device=dev)
    mc_cpu = MulticlassBinnedPrecisionRecallCurve(7, threshold=spec, device="cpu")
    for x, t in batches:
        mc_card.update(x.to(dev), t.to(dev))
        mc_cpu.update(x, t)
    card, cpu = mc_card.state_dict(), mc_cpu.state_dict()
    torch.cuda.synchronize()
    assert launches("segment_sum") == before + 1
    for name in ("num_tp", "num_fp", "num_fn"):
        assert torch.equal(card[name].cpu(), cpu[name])
    card, cpu = binary(dev), binary("cpu")
    for name in ("num_tp", "num_fp", "num_fn"):
        assert torch.equal(card[name].cpu(), cpu[name])
    one = MulticlassBinnedPrecisionRecallCurve(7, threshold=spec, device=dev)
    h = launches("hist")
    one.update(batches[0][0].to(dev), batches[0][1].to(dev)).compute()
    assert launches("hist") == h + 1  # one batch: one histogram over 2 * C * (T + 1) bins


def test_multiclass_compaction_kernel_route_is_bit_equal_to_the_two_sort(dev):
    from torcheval_tpu_torch.ops.summary import compact_count_rows, compact_count_rows_fast

    g = torch.Generator(device=dev).manual_seed(5)
    c, m = 64, 4096
    s = (torch.randint(0, 300, (c, m), generator=g, device=dev) / 256).float()
    s[:, -100:] = float("nan")
    s[0, 5] = float("nan")
    s[1, :] = 0.5
    s[2, -1] = 0.5
    tp = torch.randint(0, 3, (c, m), generator=g, device=dev, dtype=torch.int32)
    fp = torch.randint(0, 3, (c, m), generator=g, device=dev, dtype=torch.int32)
    tp[:, -100:] = 0
    fp[:, -100:] = 0
    before = launches("stream_compact")
    a = compact_count_rows(s, tp, fp)
    b = compact_count_rows_fast(s, tp, fp)
    torch.cuda.synchronize()
    assert launches("stream_compact") == before + 1
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("threshold", [None, 3000])
def test_multiclass_auroc_on_the_card_equals_the_cpu(dev, threshold):
    from torcheval_tpu_torch.metrics import MulticlassAUPRC, MulticlassAUROC

    g = torch.Generator().manual_seed(6)
    batches = [
        ((torch.randint(0, 500, (2000, 10), generator=g) / 500).float(), torch.randint(0, 10, (2000,), generator=g))
        for _ in range(4)
    ]
    for cls in (MulticlassAUROC, MulticlassAUPRC):
        card = cls(num_classes=10, average=None, compaction_threshold=threshold, device=dev)
        cpu = cls(num_classes=10, average=None, compaction_threshold=threshold, device="cpu")
        before = launches("stream_compact")
        for x, t in batches:
            card.update(x.to(dev), t.to(dev))
            cpu.update(x, t)
        got, want = card.compute(), cpu.compute()
        torch.cuda.synchronize()
        assert launches("stream_compact") == before + (0 if threshold is None else 2)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-8)


def test_precision_recall_and_exact_curve_on_the_card_equal_the_cpu(dev):
    from torcheval_tpu_torch.metrics import MulticlassPrecision, MulticlassRecall
    from torcheval_tpu_torch.metrics.functional import multiclass_precision_recall_curve

    g = torch.Generator().manual_seed(7)
    x = torch.rand(3000, 6, generator=g)
    t = torch.randint(0, 6, (3000,), generator=g)
    for cls in (MulticlassPrecision, MulticlassRecall):
        for average in ("micro", "macro", "weighted", None):
            card = cls(num_classes=6, average=average, device=dev).update(x.to(dev), t.to(dev))
            cpu = cls(num_classes=6, average=average, device="cpu").update(x, t)
            np.testing.assert_allclose(card.compute().cpu().numpy(), cpu.compute().numpy(), rtol=1e-5, atol=1e-8)
    got = multiclass_precision_recall_curve((x * 64).floor().to(dev) / 64, t.to(dev))
    want = multiclass_precision_recall_curve((x * 64).floor() / 64, t)
    for gs, ws in zip(got, want):
        for a, b in zip(gs, ws):
            assert a.device.type == "cuda" and a.shape == b.shape
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-5, atol=1e-8)


# ------------------------------------------------------------ the sketches
# the segment sum at the sketch folds' shapes (integer results bit-equal)
@pytest.mark.parametrize(
    "n,d,segments,what",
    [
        (1 << 24, 1, 1_000_000 * 33, "sliced window, 4-bit sketch over 10^6 cohorts"),
        (1 << 24, 2, 1 << 16, "binary approx=True fold of a headline chunk"),
        (1 << 26, 1, 4 << 16, "Quantile's stacked value fold of four headline chunks"),
        (10_000_000, 2, 1000 * 4096, "multiclass approx=True fold of an ImageNet-val batch"),
    ],
    ids=["sliced", "binary", "quantile", "multiclass"],
)
def test_segment_sum_at_the_sketch_fold_shapes(dev, n, d, segments, what):
    g = torch.Generator(device=dev).manual_seed(n + d)
    rows = torch.randint(-1, segments, (n,), generator=g, device=dev, dtype=torch.int32)
    vals = torch.randint(0, 2, (n, d), generator=g, device=dev, dtype=torch.int32)
    vals = vals[:, 0] if d == 1 else vals
    before = launches("segment_sum")
    got = segment_sum(vals, rows, segments)
    torch.cuda.synchronize()
    assert launches("segment_sum") == before + 1, what
    assert torch.equal(got, segment_sum_plain(vals, rows, segments)), what


def test_bucket_index_on_the_card_equals_the_cpu(dev):
    from torcheval_tpu_torch.sketch import bucket_index

    tiny = float(np.finfo(np.float32).tiny)
    special = torch.tensor(
        [0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1e-40, -1e-40, 1e-45, -1e-45,
         tiny, -tiny, 3.4e38, -3.4e38, 0.5, -0.5, 1.0], dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    x = torch.cat([special, torch.randn(100_000, generator=g) * 1e3,
                   torch.rand(100_000, generator=g)])
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        xs = x.to(dtype)
        for bits in (4, 10, 12, 16, 20):
            assert torch.equal(bucket_index(xs.to(dev), bits).cpu(), bucket_index(xs, bits)), (dtype, bits)


# the binary score fold, fused into the segment-sum kernel (score_segment_sum),
# against the tensor-op composition it replaces on the card
_TINY = float(np.finfo(np.float32).tiny)
_SPECIAL_SCORES = [
    float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 1e-40, -1e-40, 1e-45, -1e-45,
    _TINY, -_TINY, float(np.nextafter(np.float32(_TINY), 0)),
    -float(np.nextafter(np.float32(_TINY), 0)), 3.4e38, -3.4e38, 0.5, -0.5, 1.0,
    1e-300, -1e-300, 1e300, -1e300,  # float64 only: flush to 0, round to +-inf
]


def _fold_inputs(n, sdtype, target, seed):
    """``n`` scores of ``sdtype`` (normal logits, with the special values
    strided through them) and targets of the kind ``target``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, generator=g, dtype=torch.float64) * 4.0 - 3.0
    special = torch.tensor(_SPECIAL_SCORES, dtype=torch.float64)
    k = min(n, len(special))
    if k:
        x[torch.linspace(0, n - 1, k).long()] = special[:k]
    x[5::97] = float("nan")
    x[7::89] = 0.0
    u = torch.rand(n, generator=g)
    if target == "float32":
        t = (u < 0.3).to(torch.float32)
    elif target == "float32_cast":  # truncated toward zero, as .to(torch.int32) casts
        t = (u * 7.0 - 3.0).to(torch.float32)
    elif target == "int64":
        t = torch.randint(-1, 3, (n,), generator=g)
    else:
        t = u < 0.5
    return x.to(sdtype), t


def _assert_fused_fold(dev, s, t, bits):
    """The fold on the card: one fused launch, counted on its route, equal
    bit for bit to the composition on CPU copies (its plain route, which
    runs no kernel and which the CPU tests hold to the JAX package's
    counts)."""
    from torcheval_tpu_torch.ops.scatter import segment_sum_route
    from torcheval_tpu_torch.sketch.histogram import score_hist_fold, score_hist_fold_plain

    route = segment_sum_route(torch.int32, 2, 1 << bits)[0]
    before = (launches("segment_sum"), count("sketch.fused_folds", kind="score"),
              count("segment_sum.route", route=route))
    got = score_hist_fold(s, t, bits)
    torch.cuda.synchronize()
    one = int(s.numel() > 0)
    assert (launches("segment_sum"), count("sketch.fused_folds", kind="score"),
            count("segment_sum.route", route=route)) == tuple(b + one for b in before)
    want = score_hist_fold_plain(s.cpu(), t.cpu(), bits)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32 and g.shape == w.shape
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n", [0, 1, 3, 4097, (1 << 24) + 3])
@pytest.mark.parametrize("target", ["float32", "float32_cast", "int64", "bool"])
@pytest.mark.parametrize("sdtype", [torch.float32, torch.float16, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("bits", [10, 16, 20])
def test_fused_score_fold_equals_the_composition(dev, bits, sdtype, target, n):
    # bits 10, 16, 20: the local, cluster and head routes
    s, t = _fold_inputs(n, sdtype, target, seed=n + bits)
    _assert_fused_fold(dev, s.to(dev), t.to(dev), bits)


@pytest.mark.parametrize("offsets", [(1, 0), (0, 1), (1, 1), (3, 2), (2, 2)])
@pytest.mark.parametrize("target", ["float32", "int64"])
@pytest.mark.parametrize("n", [4097, (1 << 20) + 5])
def test_fused_score_fold_unaligned_views(dev, offsets, target, n):
    # the vector body's scalar head and tail; all scalar where the scores
    # and the targets reach no common 16-byte boundary
    s, t = _fold_inputs(n + 3, torch.float32, target, seed=n)
    t = t.to(torch.int32) if target == "int64" else t
    s, t = s.to(dev), t.to(dev)
    a, b = offsets
    _assert_fused_fold(dev, s[a:a + n], t[b:b + n], 16)
    _assert_fused_fold(dev, s[::2], t[::2], 16)  # strided: made contiguous


@pytest.mark.parametrize("cls", ["BinaryAUROC", "BinaryAUPRC"])
def test_approx_curves_fold_fused_on_the_card(dev, cls):
    import torcheval_tpu_torch.metrics as TM

    # CTR-like logits, one batch of 2^20 and one short one (a leftover fold)
    g = torch.Generator().manual_seed(5)
    s = torch.randn((1 << 20) + 777, generator=g) - 3.9
    t = (torch.rand(s.shape[0], generator=g) < 0.033).float()
    batches = list(zip(s.split(1 << 20), t.split(1 << 20)))

    def run(device):
        m = getattr(TM, cls)(approx=True, device=device)
        before = count("sketch.fused_folds", kind="score"), count("sketch.folds", kind="score")
        for a, b in batches:
            m.update(a.to(device), b.to(device))
        m._score_sketch_fold()
        value = m.compute()
        return m, value, (count("sketch.fused_folds", kind="score") - before[0],
                          count("sketch.folds", kind="score") - before[1])

    on, got, (fused_on, folds_on) = run(dev)
    off, want, (fused_off, folds_off) = run("cpu")
    assert folds_on == folds_off >= 1
    assert fused_on == folds_on and fused_off == 0  # one fused launch a fold on the card
    assert torch.equal(on.sketch_tp.cpu(), off.sketch_tp) and torch.equal(on.sketch_fp.cpu(), off.sketch_fp)
    assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-8)


@pytest.mark.parametrize("cls", ["BinaryAUROC", "BinaryAUPRC"])
def test_binary_sketch_on_the_card_equals_the_cpu(dev, cls):
    import torcheval_tpu_torch.metrics as TM

    g = torch.Generator().manual_seed(1)
    s = torch.randn(300_000, generator=g)
    t = (torch.rand(300_000, generator=g) < 0.4).float()
    on, off = (getattr(TM, cls)(approx=True, device=d) for d in (dev, "cpu"))
    before = launches("segment_sum")
    for a, b in zip(s.split(100_000), t.split(100_000)):
        on.update(a, b)
        off.update(a, b)
    got, want = on.compute(), off.compute()
    on._score_sketch_fold()
    off._score_sketch_fold()
    assert launches("segment_sum") > before
    assert torch.equal(on.sketch_tp.cpu(), off.sketch_tp) and torch.equal(on.sketch_fp.cpu(), off.sketch_fp)
    assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-8)


def test_multiclass_sketch_quantile_and_cat_on_the_card_equal_the_cpu(dev):
    import torcheval_tpu_torch.metrics as TM

    g = torch.Generator().manual_seed(2)
    x = torch.softmax(torch.randn(20_000, 50, generator=g), 1)
    lbl = torch.randint(0, 50, (20_000,), generator=g)
    on = TM.MulticlassAUROC(num_classes=50, average=None, approx=True, device=dev).update(x, lbl)
    off = TM.MulticlassAUROC(num_classes=50, average=None, approx=True, device="cpu").update(x, lbl)
    torch.testing.assert_close(on.compute().cpu(), off.compute(), rtol=1e-5, atol=1e-8)
    v = torch.randn(500_000, generator=g).exp()
    q_on = TM.Quantile((0.01, 0.5, 0.99), device=dev)
    q_off = TM.Quantile((0.01, 0.5, 0.99), device="cpu")
    for chunk in v.split(100_000):
        q_on.update(chunk)
        q_off.update(chunk)
    assert torch.equal(q_on.compute().cpu(), q_off.compute())
    assert torch.equal(q_on.bucket_counts.cpu(), q_off.bucket_counts)
    c_on = TM.Cat(approx=True, device=dev).update(v)
    c_off = TM.Cat(approx=True, device="cpu").update(v)
    for a, b in zip(c_on.compute(), c_off.compute()):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("bits", [4, 10])
def test_sliced_sketch_member_on_the_card_equals_the_cpu(dev, bits):
    import torcheval_tpu_torch.metrics as TM

    # scores through every normal exponent of both signs, so every bucket
    # fills; targets drawn with probability (1 + u) / 2 keep each cohort's
    # AUROC far from 0.5
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 5000, 200_000).astype(np.int64) * 7 + 1
    u = rng.uniform(-1.0, 1.0, 200_000)
    s = torch.from_numpy((np.sign(u) * np.exp2(250.0 * np.abs(u) - 125.0)).astype(np.float32))
    t = torch.from_numpy((rng.random(200_000) < (1.0 + u) / 2.0).astype(np.float32))
    cols = [TM.SlicedMetricCollection({"auroc": TM.BinaryAUROC(approx=1024, device=d)},
                                      capacity=1024, curve_bucket_bits=bits) for d in (dev, "cpu")]
    cols[0].update(ids, s.to(dev), t.to(dev))
    cols[1].update(ids, s, t)
    got, want = (c.compute()["auroc"] for c in cols)
    np.testing.assert_array_equal(got.slice_ids, want.slice_ids)
    torch.testing.assert_close(got["values"].cpu(), want["values"], rtol=1e-5, atol=1e-8)
    assert float(want["values"].mean()) > 0.7
    assert torch.equal(cols[0].metrics["auroc"].sketch_tp.cpu(), cols[1].metrics["auroc"].sketch_tp)


# ------------------------------------------ the sharded forms, a world of one
@pytest.fixture
def mesh_of_one(dev):
    """A gloo world of one rank on the card and ``cuda`` meshes over it: a
    label dim and a slice dim."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield (init_device_mesh("cuda", (1,), mesh_dim_names=("label",)),
               init_device_mesh("cuda", (1,), mesh_dim_names=("slices",)))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("k", [1, 10, 100])
def test_sharded_label_topk_at_world_of_one_launches_the_kernel(dev, mesh_of_one, k):
    from torcheval_tpu_torch.ops.topk import sharded_label_topk

    label, _ = mesh_of_one
    g = torch.Generator(device=dev).manual_seed(k)
    x = torch.randint(0, 50, (16, 60_000), generator=g, device=dev).to(torch.float32)
    t = torch.rand((16, 60_000), generator=g, device=dev)
    before = launches("topk_kernel")
    v, i, c = sharded_label_topk(x, k, mesh=label, label_axis="label", gather=t)
    torch.cuda.synchronize()
    assert launches("topk_kernel") == before + 1
    want_v, want_i = topk(x, k, method="dense")
    assert torch.equal(v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(i, want_i) and torch.equal(c, torch.gather(t, 1, want_i))


def test_row_sharded_topk_launches_the_kernel(dev):
    from torcheval_tpu_torch.ops.topk import sharded_topk_kernel

    x = torch.rand((32, 20_000), device=dev)
    before = launches("topk_kernel")
    v, i = sharded_topk_kernel(x, 7)
    torch.cuda.synchronize()
    assert launches("topk_kernel") == before + 1 and v.device == x.device
    assert torch.equal(i, topk(x, 7, method="dense")[1])


@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_tile_segment_scatter_at_world_of_one(dev, mesh_of_one, reduce):
    _, slices = mesh_of_one
    g = torch.Generator(device=dev).manual_seed(1)
    vals = torch.randint(0, 9, (100_000, 2), generator=g, device=dev, dtype=torch.int32)
    rows = torch.randint(-5, 5005, (100_000,), generator=g, device=dev, dtype=torch.int32)
    before = launches("segment_sum")
    got = segment_scatter(vals, rows, 5000, reduce=reduce, mesh=slices, axis="slices")
    torch.cuda.synchronize()
    assert launches("segment_sum") == before + (reduce == "sum")
    assert torch.equal(got.cpu(), segment_scatter(vals.cpu(), rows.cpu(), 5000, reduce=reduce))


def test_sharded_segment_sum_at_world_of_one(dev, mesh_of_one):
    from torcheval_tpu_torch.ops.scatter import sharded_segment_sum

    vals = torch.randint(0, 9, (100_000, 2), device=dev, dtype=torch.int32)
    rows = torch.randint(-5, 1005, (100_000,), device=dev)
    before = launches("segment_sum")
    got = sharded_segment_sum(vals, rows, 1000)
    torch.cuda.synchronize()
    assert launches("segment_sum") == before + 1 and got.device == vals.device
    assert torch.equal(got.cpu(), segment_sum_plain(vals.cpu(), rows.cpu(), 1000))


def test_sharded_sliced_collection_at_world_of_one_equals_the_cpu(dev, mesh_of_one):
    import torcheval_tpu_torch.metrics as TM

    _, slices = mesh_of_one
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 3000, 100_000).astype(np.int64) * 5 + 3
    s = torch.from_numpy(rng.random(100_000).astype(np.float32))
    t = torch.from_numpy((rng.random(100_000) < 0.4).astype(np.float32))

    def make(d, **kw):
        return TM.SlicedMetricCollection(
            {"acc": TM.BinaryAccuracy(device=d), "auroc": TM.BinaryAUROC(approx=1024, device=d)},
            capacity=1024, curve_bucket_bits=6, **kw)

    card = make(dev, mesh=slices, mesh_axis="slices")
    before = launches("segment_sum")
    card.update(ids, s.to(dev), t.to(dev))
    got = card.compute()
    torch.cuda.synchronize()
    assert launches("segment_sum") == before + 2
    want = make("cpu").update(ids, s, t).compute()
    for name in ("acc", "auroc"):
        np.testing.assert_array_equal(got[name].slice_ids, want[name].slice_ids)
        assert torch.equal(got[name]["values"].cpu(), want[name]["values"])


def test_label_mesh_ndcg_on_the_card_equals_the_cpu(dev, mesh_of_one):
    label, _ = mesh_of_one
    g = torch.Generator(device=dev).manual_seed(2)
    s = torch.rand((64, 50_000), generator=g, device=dev)
    t = (torch.rand((64, 50_000), generator=g, device=dev) < 1e-3).to(torch.float32)
    card = NDCG(k=10, label_mesh=(label, "label"), device=dev)
    before = launches("topk_kernel")
    card.update(s[:32], t[:32]).update(s[32:], t[32:])
    value = card.compute()
    torch.cuda.synchronize()
    assert launches("topk_kernel") == before + 4  # the ranking and the ideal, per batch
    cpu = NDCG(k=10, device="cpu").update(s.cpu()[:32], t.cpu()[:32]).update(s.cpu()[32:], t.cpu()[32:])
    torch.testing.assert_close(value.cpu(), cpu.compute(), rtol=1e-5, atol=1e-8)


# ---------------------------------- the distributed curves, a world of one
@pytest.fixture
def data_of_one(dev):
    """A gloo world of one rank on the card and a ``cuda`` mesh over it with
    a data dim."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def _tied_scores(n, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    s = torch.randint(0, 300, (n,), generator=g, device=dev).to(torch.float32) / 300.0
    return s, (torch.rand((n,), generator=g, device=dev) < 0.4).to(torch.float32)


@pytest.mark.parametrize("which", ["auroc", "auprc"])
def test_dist_binary_curve_at_world_of_one_equals_the_cpu(dev, data_of_one, which):
    from torcheval_tpu_torch.ops import dist_curves as dc
    from torcheval_tpu_torch.ops.curves import binary_auprc_kernel, binary_auroc_kernel
    from torcheval_tpu_torch.utils.dist import mesh_axis

    fn = dc.sharded_binary_auroc if which == "auroc" else dc.sharded_binary_auprc
    s, t = _tied_scores(1 << 20, 3, dev)
    s[:1000] = -0.0
    before = (launches("hist"), count("dist_curves.exchanges"))
    value, err = fn([s[:300_000], s[300_000:]], [t[:300_000], t[300_000:]],
                    group=mesh_axis(data_of_one, "data"))
    torch.cuda.synchronize()
    assert (launches("hist"), count("dist_curves.exchanges")) == (before[0] + 1, before[1] + 1)
    assert err == 0 and value.device == s.device
    want = (binary_auroc_kernel if which == "auroc" else binary_auprc_kernel)(s.cpu(), t.cpu())
    torch.testing.assert_close(value.cpu(), want, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("which", ["mc_auroc", "mc_auprc"])
def test_dist_multiclass_curve_at_world_of_one_equals_the_cpu(dev, data_of_one, which):
    from torcheval_tpu_torch.ops import dist_curves as dc
    from torcheval_tpu_torch.ops.curves import multiclass_auprc_kernel, multiclass_auroc_kernel

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.softmax(torch.randn((20_000, 100), generator=g, device=dev) * 3, dim=1)
    y = torch.randint(0, 100, (20_000,), generator=g, device=dev)
    fn = dc.sharded_multiclass_auroc if which == "mc_auroc" else dc.sharded_multiclass_auprc
    before = launches("segment_sum")
    value, err = fn([x], [y])
    torch.cuda.synchronize()
    assert launches("segment_sum") == before + 1 and err == 0
    want = (multiclass_auroc_kernel if which == "mc_auroc" else multiclass_auprc_kernel)(x.cpu(), y.cpu())
    torch.testing.assert_close(value.cpu(), want, rtol=1e-5, atol=1e-8)


def test_dist_nan_and_abstention_at_world_of_one(dev, data_of_one):
    from torcheval_tpu_torch.ops import dist_curves as dc

    s, t = _tied_scores(10_000, 6, dev)
    s[7] = float("nan")
    assert dc.sharded_binary_auroc([s], [t])[1] == 1
    before = count("dist_curves.exchanges")
    assert dc.curve_value("auroc", [s], [t], abstain=True) is None
    assert count("dist_curves.exchanges") == before  # stood down after the splitter


def test_splitter_histogram_kernels_equal_their_plain_versions(dev):
    from torcheval_tpu_torch.ops import dist_curves as dc

    bins = dc.splitter_bins(dc.order_key(torch.rand((1 << 22,), device=dev) - 0.5))
    assert torch.equal(hist(bins, dc.HIST_BINS), hist_plain(bins, dc.HIST_BINS))
    keys = dc.splitter_bins(dc.order_key(torch.rand((100, 20_000), device=dev)))
    combined = (keys + torch.arange(100, device=dev, dtype=torch.int32)[:, None] * dc.HIST_BINS).reshape(-1)
    ones = torch.ones_like(combined)
    assert torch.equal(segment_sum(ones, combined, 100 * dc.HIST_BINS),
                       segment_sum_plain(ones, combined, 100 * dc.HIST_BINS))


@pytest.mark.parametrize("classes", [None, 50])
def test_dist_sketch_counts_at_world_of_one_equal_the_cpu(dev, data_of_one, classes):
    from torcheval_tpu_torch.ops import dist_curves as dc

    g = torch.Generator(device=dev).manual_seed(8)
    if classes is None:
        s, t = torch.randn((1 << 20,), generator=g, device=dev), torch.rand((1 << 20,), device=dev) < 0.3
        bits = 16
    else:
        s = torch.rand((50_000, classes), generator=g, device=dev)
        t = torch.randint(0, classes, (50_000,), generator=g, device=dev)
        bits = 12
    base = dc.sharded_sketch_counts([s.cpu()], [t.cpu()], bucket_bits=bits, num_classes=classes)
    before = launches("segment_sum")
    got = dc.sharded_sketch_counts([s], [t], bucket_bits=bits, num_classes=classes,
                                   base=tuple(x.to(dev) for x in base))
    torch.cuda.synchronize()
    assert launches("segment_sum") == before + 1
    for a, b in zip(got, base):
        assert torch.equal(a.cpu(), 2 * b)


# ---------------- recommendation and regression metrics, quantized routes
def _rec_batch(dev, seed, shape=(3, 4096)):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev) * 2
    t = (torch.rand(shape, generator=g, device=dev) < 0.03).to(torch.float32)
    w = torch.rand(shape, generator=g, device=dev) + 0.5
    return x, t, w


def _rec_metrics(device, num_tasks=3):
    from torcheval_tpu_torch.metrics import (
        BinaryNormalizedEntropy,
        ClickThroughRate,
        WeightedCalibration,
        WindowedClickThroughRate,
        WindowedWeightedCalibration,
    )

    return {
        "ne": BinaryNormalizedEntropy(num_tasks=num_tasks, from_logits=True, device=device),
        "ctr": ClickThroughRate(num_tasks=num_tasks, device=device),
        "cal": WeightedCalibration(num_tasks=num_tasks, device=device),
        "wctr": WindowedClickThroughRate(num_tasks=num_tasks, window_size=3, device=device),
        "wcal": WindowedWeightedCalibration(num_tasks=num_tasks, window_size=3, device=device),
    }


def _feed_rec(metrics, x, t, w):
    metrics["ne"].update(x, t, weight=w)
    metrics["ctr"].update(t, w)
    metrics["wctr"].update(t, w)
    p = torch.sigmoid(x)
    metrics["cal"].update(p, t, w)
    metrics["wcal"].update(p, t, w)


def test_rec_metrics_on_the_card_equal_the_cpu(dev):
    card, cpu = _rec_metrics(dev), _rec_metrics("cpu")
    for i in range(5):
        x, t, w = _rec_batch(dev, 40 + i)
        _feed_rec(card, x, t, w)
        _feed_rec(cpu, x.cpu(), t.cpu(), w.cpu())
    for k in card:
        got, want = card[k].compute(), cpu[k].compute()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, c in zip(got, want):
            assert g.device.type == "cuda"
            torch.testing.assert_close(g.cpu(), c, rtol=1e-5, atol=1e-8)


def test_rec_collection_window_on_the_card_equals_the_cpu(dev):
    from torcheval_tpu_torch.metrics import BinaryNormalizedEntropy, MetricCollection, R2Score

    col = MetricCollection({"r2": R2Score(multioutput="raw_values", device=dev)})
    ne = MetricCollection({"ne": BinaryNormalizedEntropy(num_tasks=3, from_logits=True, device=dev)})
    r2_cpu, ne_cpu = R2Score(multioutput="raw_values", device="cpu"), BinaryNormalizedEntropy(
        num_tasks=3, from_logits=True, device="cpu")
    g = torch.Generator(device=dev).manual_seed(9)
    for i in range(4):
        y = torch.randn((10_000, 8), generator=g, device=dev)
        yhat = y + 0.5 * torch.randn((10_000, 8), generator=g, device=dev)
        col.update(yhat, y)
        r2_cpu.update(yhat.cpu(), y.cpu())
        x, t, _ = _rec_batch(dev, 60 + i)
        ne.update(x, t)
        ne_cpu.update(x.cpu(), t.cpu())
    torch.testing.assert_close(col.compute()["r2"].cpu(), r2_cpu.compute(), rtol=1e-5, atol=1e-8)
    torch.testing.assert_close(ne.compute()["ne"].cpu(), ne_cpu.compute(), rtol=1e-5, atol=1e-8)


def test_throughput_and_async_warning_on_the_card(dev, caplog):
    import logging

    from torcheval_tpu_torch.metrics import MulticlassRecall, Throughput
    from torcheval_tpu_torch.utils.tracing import join_pending

    m = Throughput(device=dev).update(1000, 2.0)
    assert m.compute().device.type == "cuda" and float(m.compute()) == 500.0
    with caplog.at_level(logging.WARNING):
        labels = torch.tensor([0, 0, 2, 2], device=dev)
        MulticlassRecall(num_classes=3, average="macro", device=dev).update(
            torch.nn.functional.one_hot(labels, 3).float(), labels).compute()
        assert join_pending(timeout=60)
    assert any("ground-truth instances of [1]" in r.message for r in caplog.records)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("which", ["auroc", "mc_auprc"])
def test_quantized_dist_curves_at_world_of_one_equal_raw(dev, data_of_one, which, mode):
    from torcheval_tpu_torch.ops import dist_curves as dc

    if which == "auroc":
        s, t = _tied_scores(1 << 20, 11, dev)
        fn = dc.sharded_binary_auroc
        row = 5
    else:
        g = torch.Generator(device=dev).manual_seed(12)
        s = torch.softmax(torch.randn((20_000, 64), generator=g, device=dev) * 3, dim=1)
        t = torch.randint(0, 64, (20_000,), generator=g, device=dev)
        fn = dc.sharded_multiclass_auprc
        row = 6
    raw, raw_err = fn([s], [t], quantize=False)
    sent = count("dist_curves.exchange_send_bytes")
    got, err = fn([s], [t], quantize=mode)
    torch.cuda.synchronize()
    assert err == raw_err == 0
    assert (count("dist_curves.exchange_send_bytes") - sent) == row * s.shape[0] * (1 if s.ndim == 1 else s.shape[1])
    torch.testing.assert_close(got, raw, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("seed", range(8))
def test_q8_blocks_on_the_card_equal_the_host_codec(dev, seed):
    from torcheval_tpu_torch.ops.dist_curves import _q8_blocks
    from torcheval_tpu_torch.utils.quant import q8_parts

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(1 << 16, generator=g, device=dev) * 1000
    scales, q = _q8_blocks(x)
    want_s, want_q = q8_parts(x.cpu().numpy())
    # the same bytes as the host codec: the scales too
    assert np.array_equal(scales.cpu().numpy().view(np.int32), want_s.view(np.int32))
    assert np.array_equal(q.cpu().numpy(), want_q)


# ------------------------------------------------ checkpoints on the card
def _ckpt_pair(device, threshold=1 << 12):
    from torcheval_tpu_torch.metrics import BinaryAUROC

    return {"acc": MulticlassAccuracy(num_classes=5, device=device),
            "auroc": BinaryAUROC(compaction_threshold=threshold, device=device)}


def _ckpt_feed(pair, device, n_batches, seed=0, n=3000):
    g = torch.Generator().manual_seed(seed)
    for _ in range(n_batches):
        scores, labels = torch.rand((n, 5), generator=g), torch.randint(0, 5, (n,), generator=g)
        logits = torch.rand(n, generator=g)
        pair["acc"].update(scores.to(device), labels.to(device))
        pair["auroc"].update(logits.to(device), (labels == 0).float().to(device))


def _ckpt_states(pair):
    """Every state leaf on the host as ``(dtype, shape, bytes)``: a NaN pad
    of a summary compares equal as bytes, not by ``torch.equal``."""
    out = {}
    for k, m in pair.items():
        for name, v in m.state_dict().items():
            leaves = v if isinstance(v, list) else [v]
            out[(k, name)] = [(x.dtype, tuple(x.shape), x.detach().cpu().reshape(-1).view(torch.uint8))
                              for x in leaves]
    return out


def _same_states(got, want):
    assert list(got) == list(want)
    for key in want:
        assert len(got[key]) == len(want[key]), key
        for (gd, gs, gb), (wd, ws, wb) in zip(got[key], want[key]):
            assert (gd, gs) == (wd, ws) and torch.equal(gb, wb), key


def _leaf_devices(metric):
    for v in metric._states().values():
        for x in (v if isinstance(v, list) else [v]):
            yield x.device


@pytest.mark.parametrize("src,dst", [("cuda", "cuda"), ("cuda", "cpu"), ("cpu", "cuda")])
def test_checkpoint_between_card_and_host(dev, tmp_path, src, dst):
    from torcheval_tpu_torch.resilience import restore, save

    source = _ckpt_pair(src)
    _ckpt_feed(source, src, 3)
    target = restore(_ckpt_pair(dst), save(source, str(tmp_path)))
    _same_states(_ckpt_states(target), _ckpt_states(source))
    for k in source:
        assert all(d.type == dst for d in _leaf_devices(target[k]))
        assert torch.equal(target[k].compute().cpu(), source[k].compute().cpu())


def test_restore_stages_through_one_pinned_buffer(dev, tmp_path, monkeypatch):
    from torcheval_tpu_torch.resilience import restore, save
    from torcheval_tpu_torch.resilience import snapshot as snap

    source = _ckpt_pair(dev)
    _ckpt_feed(source, dev, 3)
    path = save(source, str(tmp_path))
    staged, copies = [], []
    real_empty, real_to = torch.empty, torch.Tensor.to

    def empty(*args, **kwargs):
        out = real_empty(*args, **kwargs)
        if kwargs.get("pin_memory"):
            staged.append(out)
        return out

    def to(self, *args, **kwargs):
        if any(self is s for s in staged):
            copies.append(kwargs.get("non_blocking"))
        return real_to(self, *args, **kwargs)

    monkeypatch.setattr(snap.torch, "empty", empty)
    monkeypatch.setattr(torch.Tensor, "to", to)
    target = restore(_ckpt_pair(dev), path)
    monkeypatch.undo()
    assert len(staged) == 1 and staged[0].is_pinned() and copies == [True]
    for k in source:
        assert torch.equal(target[k].compute(), source[k].compute())


def test_restore_placement_error_raises(dev, tmp_path, monkeypatch):
    from torcheval_tpu_torch.resilience import restore, save
    from torcheval_tpu_torch.resilience import snapshot as snap

    source = _ckpt_pair(dev)
    _ckpt_feed(source, dev, 1)
    path = save(source, str(tmp_path))

    def refuse(*args, **kwargs):
        raise RuntimeError("placement refused")

    monkeypatch.setattr(snap.torch, "empty", refuse)
    target = _ckpt_pair(dev)
    with pytest.raises(RuntimeError, match="placement refused"):
        restore(target, path)
    assert int(target["acc"].num_total) == 0  # nothing installed


def test_restored_binary_auroc_compacts_on_the_card(dev, tmp_path):
    from torcheval_tpu_torch.resilience import restore, save

    source = _ckpt_pair(dev)
    _ckpt_feed(source, dev, 2)
    target = restore(_ckpt_pair(dev), save(source, str(tmp_path)))
    before = launches("stream_compact")
    for pair in (source, target):
        _ckpt_feed(pair, dev, 2, seed=1)
        pair["auroc"].compute()
    torch.cuda.synchronize()
    assert launches("stream_compact") >= before + 2
    _same_states(_ckpt_states(target), _ckpt_states(source))
    assert torch.equal(target["auroc"].compute(), source["auroc"].compute())


# ------------------------------------------------------------ the serve plane
def test_a_cuda_pool_pins_its_slots(dev):
    from torcheval_tpu_torch.serve.ingest import HostBufferPool

    pool = HostBufferPool(device=dev)
    buf = pool.acquire(10_000)
    assert pool.pinned and buf.tensor.is_pinned()
    buf.view(4)[:] = b"abcd"
    assert bytes(buf.tensor[:4].numpy()) == b"abcd"  # one memory, two views


def test_a_copy_stream_slot_is_not_recycled_before_its_event(dev):
    from torcheval_tpu_torch.serve.ingest import HostBufferPool, coalesce_h2d

    pool = HostBufferPool(device=dev)
    stream = torch.cuda.Stream(device=dev)
    rng = np.random.default_rng(0)
    batch = (rng.random((1 << 16, 8)).astype(np.float32), rng.integers(0, 8, 1 << 16))
    with torch.cuda.stream(stream):
        torch.cuda._sleep(200_000_000)  # hold the copy stream busy
    placed, owned, event = coalesce_h2d([batch], dev, pool=pool, stream=stream)
    assert owned == [True] and isinstance(event, torch.cuda.Event)
    assert pool.stats()["cooling"] == 1  # the staging slot waits on the copy
    first = pool._cooling[0][0]
    assert pool.acquire(first.nbytes) is not first
    # the consumer (this thread's current stream) waited on the copy
    assert torch.equal(placed[0][0].cpu(), torch.from_numpy(batch[0]))
    assert torch.equal(placed[0][1].cpu(), torch.from_numpy(batch[1]))
    torch.cuda.synchronize()
    assert event.query()
    pool.shrink()
    assert pool.stats()["cooling"] == 0


def test_update_placed_owned_equals_update_on_the_card(dev):
    from torcheval_tpu_torch.metrics import MetricCollection, MulticlassF1Score

    rng = np.random.default_rng(1)
    batches = [(rng.random((4096, 10)).astype(np.float32), rng.integers(0, 10, 4096)) for _ in range(4)]

    def col():
        return MetricCollection(
            {"acc": MulticlassAccuracy(num_classes=10, device=dev),
             "f1": MulticlassF1Score(num_classes=10, average="macro", device=dev)}
        )  # fmt: skip

    ref, placed = col(), col()
    for s, l in batches:
        ref.update(s, l)
        placed.update_placed((torch.from_numpy(s).to(dev), torch.from_numpy(l).to(dev)), owned=True)
    want, got = ref.compute(), placed.compute()
    for k in want:
        assert torch.equal(got[k], want[k])
    with pytest.raises(ValueError, match="update_placed"):
        placed.update_placed((torch.zeros(2, 10), torch.zeros(2, dtype=torch.long)))


def test_a_served_tenant_equals_a_direct_collection_on_the_card(dev):
    from torcheval_tpu_torch.metrics import MetricCollection, MulticlassF1Score
    from torcheval_tpu_torch.serve import EvalClient, EvalDaemon, EvalServer

    rng = np.random.default_rng(2)
    batches = [(rng.random((8192, 1000)).astype(np.float32), rng.integers(0, 1000, 8192)) for _ in range(3)]

    def members():
        return {"acc": MulticlassAccuracy(num_classes=1000, average="macro", device=dev),
                "f1": MulticlassF1Score(num_classes=1000, average="macro", device=dev)}  # fmt: skip

    direct = MetricCollection(members())
    for s, l in batches:
        direct.update(s, l)
    want = direct.compute()
    before = launches("hist")
    with EvalDaemon() as daemon:
        assert daemon.device == dev
        h = daemon.attach("local", members())
        for s, l in batches:
            h.submit(s, l, block=True, timeout=60)
        got = h.compute(timeout=120)
        server = EvalServer(daemon)
        client = EvalClient(server.endpoint, local_transport=False)
        try:
            client.attach("wire", {"acc": ["MulticlassAccuracy", {"num_classes": 1000, "average": "macro"}],
                                   "f1": ["MulticlassF1Score", {"num_classes": 1000, "average": "macro"}]})
            for s, l in batches:
                client.submit("wire", s, l)
            wire = client.compute("wire")
        finally:
            client.close()
            server.close()
        assert daemon.health()["tenants"]["local"]["status"] == "active"
    assert launches("hist") > before
    for k in want:
        assert torch.equal(got[k], want[k])
        assert np.asarray(wire[k]).tobytes() == want[k].cpu().numpy().tobytes()


# ------------------------------------------------ tools and examples
def _summary_nodes(ms, out=None):
    out = {} if out is None else out
    out[ms.module_name] = ms
    for child in ms.submodule_summaries.values():
        _summary_nodes(child, out)
    return out


def test_tools_on_the_card_give_the_cpus_counts(dev):
    from torcheval_tpu_torch.tools import get_module_summary

    model = torch.nn.Sequential(
        torch.nn.Conv2d(3, 16, 7, stride=2, padding=3), torch.nn.ReLU(),
        torch.nn.Conv2d(16, 32, 3, stride=2, padding=1), torch.nn.ReLU(),
        torch.nn.Flatten(), torch.nn.Linear(32 * 8 * 8, 10))
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    cpu = _summary_nodes(get_module_summary(model, (x,)))
    model.to(dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    card = _summary_nodes(get_module_summary(model, (x.to(dev),)))
    assert card.keys() == cpu.keys()
    for name, c in cpu.items():
        g = card[name]
        assert (g.num_parameters, g.num_trainable_parameters, g.size_bytes, g.flops_forward,
                g.flops_backward) == (c.num_parameters, c.num_trainable_parameters, c.size_bytes,
                                      c.flops_forward, c.flops_backward), name
    assert cpu[""].flops_forward > 0 and cpu[""].flops_backward > 0
    for k, v in model.state_dict().items():
        assert v.device == dev and torch.equal(v, before[k]), k


def test_examples_default_to_the_card(dev):
    from torcheval_tpu_torch.examples import simple_example, torch_bridge_example

    simple = simple_example.main([])
    assert simple["device"] == dev and len(simple["records"]) == 16
    replay, values = MulticlassAccuracy(device="cpu"), []
    for step, (logits, labels) in enumerate(zip(simple["logits"], simple["labels"])):
        replay.update(logits, labels)
        if (step + 1) % 4 == 0:
            values.append(float(replay.compute()))
        if (step + 1) % 16 == 0:
            replay.reset()
    assert values == [r["accuracy"] for r in simple["records"]]
    before = launches("hist")
    bridge = torch_bridge_example.main([])
    assert bridge["device"] == dev and launches("hist") > before
    assert 0.9 < bridge["accuracy"] <= 1.0


def test_a_ragged_window_folds_each_accuracy_once_on_the_card(dev, monkeypatch):
    """The ImageNet cell's window at batch 256, cut to six batches: five
    (256, 1000) and one (80, 1000). Top-1, top-5 and the macro top-1 fold
    the concatenated rows in one call each, none batch by batch, and their
    counts equal the same window's on the CPU."""
    from torcheval_tpu_torch.metrics import MetricCollection

    g = torch.Generator().manual_seed(256)
    scores = torch.rand(5 * 256 + 80, 1000, generator=g)
    labels = torch.randint(0, 1000, (5 * 256 + 80,), generator=g)

    def window(device):
        col = MetricCollection({
            "top1": MulticlassAccuracy(device=device),
            "top5": MulticlassAccuracy(k=5, device=device),
            "top1_macro": MulticlassAccuracy(average="macro", num_classes=1000, device=device),
        })  # fmt: skip
        for s in range(0, scores.shape[0], 256):
            col.update(scores[s:s + 256].to(device), labels[s:s + 256].to(device))
        return col

    want = {k: m.state_dict() for k, m in window("cpu").metrics.items()}
    calls, fold_fn = [], MulticlassAccuracy._fold_fn

    def counting(*args):
        calls.append(1)
        return fold_fn(*args)

    monkeypatch.setattr(MulticlassAccuracy, "_fold_fn", staticmethod(counting))
    ragged, concat = count("deferred.fold_calls", shape="ragged"), count("deferred.fold_calls", shape="concat")
    col = window(dev)
    got = {k: m.state_dict() for k, m in col.metrics.items()}
    torch.cuda.synchronize()
    assert len(calls) == 3
    assert count("deferred.fold_calls", shape="ragged") == ragged
    assert count("deferred.fold_calls", shape="concat") == concat + 3
    for k, states in want.items():
        for name, v in states.items():
            assert got[k][name].device == dev and torch.equal(got[k][name].cpu(), v), (k, name)


# ------------------------------------------- the exact AUROC's stream route
# ops/roc_stream.py: the key pass, the (key, label) radix sort and the
# integration over tie-group ends, held to the composition on the CPU (the
# route the CPU tests hold to the JAX package), to its own plain version
# (bit for bit: the same integers, the same rounding), and, where no NaN
# score plays, to a float64 Mann-Whitney AUROC with ties at one half
_TILE = 4096  # csrc/roc_stream.cu: kThreads x kItems rows a tile


def _rank_auroc64(x, t):
    """The float64 rank AUROC of NaN-free scores, ties at one half."""
    xs, order = torch.sort(x.to(torch.float64))
    ts = t.to(torch.float64)[order]
    _, counts = torch.unique_consecutive(xs, return_counts=True)
    ends = torch.cumsum(counts, 0).to(torch.float64)
    rank = (ends - counts + 1 + ends) / 2
    gid = torch.repeat_interleave(torch.arange(counts.numel(), device=x.device), counts)
    pos = torch.zeros_like(rank).index_add_(0, gid, ts)
    p = float(ts.sum())
    q = ts.numel() - p
    return (float((rank * pos).sum()) - p * (p + 1) / 2) / (p * q)


def _stream_case(name, n, seed):
    """CPU scores and float32 {0, 1} targets of a named case."""
    g = torch.Generator().manual_seed(seed)
    t = (torch.rand(n, generator=g) < 0.3).float()
    if name == "heavy_ties":  # groups of about n / 8 rows, each over many tiles
        x = torch.randint(0, 8, (n,), generator=g).float() / 8
    elif name == "one_group":
        x = torch.full((n,), 0.25)
    elif name == "straddling":  # groups of 37 rows across every tile edge
        x = (torch.arange(n) // 37).float()[torch.randperm(n, generator=g)]
    elif name == "integer_valued":
        x = torch.randint(-1000, 1000, (n,), generator=g).float()
    elif name == "signed_zero":
        x = torch.tensor([0.0, -0.0, 1.0, -1.0])[torch.randint(0, 4, (n,), generator=g)]
    elif name == "infinities":
        x = torch.randn(n, generator=g)
        x[torch.rand(n, generator=g) < 0.2] = float("inf")
        x[torch.rand(n, generator=g) < 0.2] = -float("inf")
    elif name == "distinct":
        x = torch.randn(n, generator=g)
    elif name == "all_positive":
        x, t = torch.randn(n, generator=g), torch.ones(n)
    else:  # all_negative
        x, t = torch.randn(n, generator=g), torch.zeros(n)
    return x, t


def _assert_stream_auroc(dev, x, t, nan_free=True):
    """The stream route on the card: one ``stream`` route a call, bit-equal
    to its plain version, within 1e-6 relative of the CPU composition and of
    the float64 rank AUROC."""
    from torcheval_tpu_torch.ops import roc_stream
    from torcheval_tpu_torch.ops.curves import binary_auroc_kernel

    want = float(binary_auroc_kernel(x.cpu(), t.cpu()))
    plain = roc_stream.binary_auroc_stream_plain(x.to(dev), t.to(dev))
    before = count("curves.auroc_route", route="stream")
    got = binary_auroc_kernel(x.to(dev), t.to(dev))
    torch.cuda.synchronize()
    assert count("curves.auroc_route", route="stream") == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.float32 and got.shape == ()
    assert torch.equal(got, plain[0])
    assert abs(float(got) - want) <= 1e-6 * abs(want)
    labels = t.to(torch.int32)  # the composition's cast
    if nan_free and x.numel() and 0 < int(labels.sum()) < t.numel():
        ref = _rank_auroc64(x.to(dev), labels.to(dev))
        assert abs(float(got) - ref) <= 1e-6 * ref
    return got


_STREAM_CASES = ["heavy_ties", "one_group", "straddling", "integer_valued", "signed_zero",
                 "infinities", "distinct", "all_positive", "all_negative"]


@pytest.mark.parametrize("n", [1, 3, _TILE - 1, _TILE, _TILE + 1, 5 * _TILE + 5, (1 << 20) + 3])
@pytest.mark.parametrize("case", _STREAM_CASES)
def test_stream_auroc_equals_the_composition(dev, case, n):
    x, t = _stream_case(case, n, n)
    _assert_stream_auroc(dev, x, t)


@pytest.mark.parametrize("at", ["first", "middle", "last", "scattered", "all"])
@pytest.mark.parametrize("n", [7, 3 * _TILE + 11])
def test_stream_auroc_keeps_nan_rows_in_input_order(dev, at, n):
    """Every NaN row is a group of its own, after every real score, in
    input order: the composition's stable sort."""
    x, t = _stream_case("heavy_ties", n, 3)
    t[::2] = 1.0  # labels among the NaN rows that move the area with their order
    where = {"first": slice(0, 3), "middle": slice(n // 2, n // 2 + 3),
             "last": slice(n - 3, n), "scattered": slice(0, n, 5), "all": slice(0, n)}[at]
    x[where] = float("nan")
    if at == "scattered":
        x[1] = -float("nan")  # a NaN of the other sign: the same key
    _assert_stream_auroc(dev, x, t, nan_free=False)


@pytest.mark.parametrize("tdtype", [torch.bool, torch.int64, torch.int32, torch.uint8,
                                    torch.float32, torch.float64, torch.float16])
@pytest.mark.parametrize("sdtype", [torch.float32, torch.float16, torch.bfloat16])
def test_stream_auroc_takes_every_binary_target_type(dev, sdtype, tdtype):
    x, t = _stream_case("integer_valued", 2 * _TILE + 3, 11)
    _assert_stream_auroc(dev, (x / 64).to(sdtype), t.to(tdtype))


@pytest.mark.parametrize("values", [[0.0, 1.0, 0.5, 1.5, -0.5], [0, 1, 1]])
def test_stream_auroc_takes_targets_whose_cast_is_binary(dev, values):
    x, _ = _stream_case("heavy_ties", 10_000, 12)
    g = torch.Generator().manual_seed(12)
    t = torch.tensor(values)[torch.randint(0, len(values), (10_000,), generator=g)]
    _assert_stream_auroc(dev, x, t)


@pytest.mark.parametrize("values,dtype", [
    ([0.0, 1.0, 2.0], torch.float32), ([0.0, 1.0, -1.0], torch.float32),
    ([0, 1, 2], torch.int64), ([0, 1, 3], torch.uint8), ([0.0, 1.0, float("nan")], torch.float32),
])
def test_stream_auroc_gives_other_targets_to_the_composition(dev, values, dtype):
    """A target whose int32 cast is not 0 or 1 (one row is enough) takes the
    composition on the card, which equals the CPU's."""
    from torcheval_tpu_torch.ops.curves import binary_auroc_kernel

    n = 3 * _TILE + 7
    x, _ = _stream_case("heavy_ties", n, 13)
    g = torch.Generator().manual_seed(13)
    t = torch.tensor(values[:2], dtype=dtype)[torch.randint(0, 2, (n,), generator=g)]
    t[n // 3] = torch.tensor(values[2], dtype=dtype)
    if dtype != torch.float32 or values[2] == values[2]:  # NaN casts differ by device
        want = float(binary_auroc_kernel(x, t))
    before = (count("curves.auroc_route", route="stream"),
              count("curves.auroc_route", route="composition"))
    got = binary_auroc_kernel(x.to(dev), t.to(dev))
    torch.cuda.synchronize()
    assert count("curves.auroc_route", route="stream") == before[0]
    assert count("curves.auroc_route", route="composition") == before[1] + 1
    if dtype != torch.float32 or values[2] == values[2]:
        assert abs(float(got) - want) <= 1e-6 * abs(want)


def test_stream_auroc_of_nothing_is_one_half(dev):
    from torcheval_tpu_torch.ops.curves import binary_auroc_kernel

    got = binary_auroc_kernel(torch.empty(0, device=dev), torch.empty(0, device=dev))
    assert float(got) == 0.5 == float(binary_auroc_kernel(torch.empty(0), torch.empty(0)))
    assert count("curves.auroc_route", route="stream") == 1


def test_stream_auroc_steps_equal_their_plain_versions(dev, monkeypatch):
    """One route call over two parts, its buffers read where ``_carve``
    put them: the sorted keys and labels that the integration reads, bit
    for bit the plain keys sorted stably and the labels they carry, and
    the doubled area and the positives as the plain version's integers."""
    from torcheval_tpu_torch.ops import roc_stream

    x, t = _stream_case("straddling", 7 * _TILE + 13, 14)
    x[5] = float("nan")
    x[17] = -0.0
    x[: 3 * _TILE] = 2.5  # one group over three tiles
    x, t = x.to(dev), t.to(dev)
    carved, seen = [], {}
    carve, integrate = roc_stream._carve, roc_stream._integrate

    def carve_and_keep(n, lib, device):
        carved.append(carve(n, lib, device))
        return carved[-1]

    def integrate_and_keep(lib, keys, labels, scratch, totals, out):
        seen.update(keys=keys, labels=labels, totals=totals)
        integrate(lib, keys, labels, scratch, totals, out)

    monkeypatch.setattr(roc_stream, "_carve", carve_and_keep)
    monkeypatch.setattr(roc_stream, "_integrate", integrate_and_keep)
    auc = roc_stream.binary_auroc_stream([x[:1000], x[1000:]], [t[:1000], t[1000:]])
    torch.cuda.synchronize()
    ((keys, keys_alt, labels, labels_alt, _, _),) = carved
    read = (seen["keys"].data_ptr(), seen["labels"].data_ptr())
    assert read in ((keys.data_ptr(), labels.data_ptr()), (keys_alt.data_ptr(), labels_alt.data_ptr()))
    ref_keys, order = torch.sort(roc_stream.order_keys_plain(x), stable=True)
    assert torch.equal(seen["keys"].to(torch.int64) & 0xFFFFFFFF, ref_keys)
    assert torch.equal(seen["labels"], t.to(torch.uint8)[order])
    plain_auc, area, p = roc_stream.binary_auroc_stream_plain(x, t)
    assert seen["totals"][:2].tolist() == [area, p] and torch.equal(auc, plain_auc)


def test_stream_auroc_reads_a_many_part_cache_in_place(dev, monkeypatch):
    """A raw ``BinaryAUROC`` cache of several updates reaches the stream
    route as its parts (no concatenation), one route a ``compute()``; the
    value equals the CPU metric's."""
    from torcheval_tpu_torch.metrics import BinaryAUROC
    from torcheval_tpu_torch.ops import roc_stream

    seen = []
    real = roc_stream.binary_auroc_stream
    monkeypatch.setattr(roc_stream, "binary_auroc_stream",
                        lambda s, t: seen.append(len(s)) or real(s, t))
    g = torch.Generator().manual_seed(15)
    batches = [(torch.randint(0, 50, (n,), generator=g) / 50.0, (torch.rand(n, generator=g) < 0.2))
               for n in (3000, _TILE, 1, 2 * _TILE + 9)]
    card, cpu = BinaryAUROC(device=dev), BinaryAUROC(device="cpu")
    for x, t in batches:
        card.update(x.to(dev), t.to(dev))
        cpu.update(x, t)
    want = float(cpu.compute())
    before = count("curves.auroc_route", route="stream")
    keys0, sort0 = count("roc_stream.launches", step="keys"), count("roc_stream.launches", step="sort")
    got = float(card.compute())
    assert seen == [4] and count("curves.auroc_route", route="stream") == before + 1
    # one key-pass launch a part, one sort
    assert count("roc_stream.launches", step="keys") == keys0 + 4
    assert count("roc_stream.launches", step="sort") == sort0 + 1
    assert abs(got - want) <= 1e-6 * want


def test_multiclass_rows_keep_the_composition_on_the_card(dev):
    from torcheval_tpu_torch.metrics.functional import multiclass_auroc

    g = torch.Generator().manual_seed(16)
    x, t = torch.rand(5000, 7, generator=g), torch.randint(0, 7, (5000,), generator=g)
    got = multiclass_auroc(x.to(dev), t.to(dev), num_classes=7, average=None)
    want = multiclass_auroc(x, t, num_classes=7, average=None)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-8)
    assert count("curves.auroc_route", route="stream") == 0
    assert count("curves.auroc_route", route="composition") == 2  # the card's and the CPU's


def test_stream_auroc_at_the_criteo_pass(dev):
    """89,137,319 float32 CTR logits and labels (the criteo cell's pass)
    against the float64 rank AUROC and the plain version."""
    from torcheval_tpu_torch.ops import roc_stream
    from torcheval_tpu_torch.ops.curves import binary_auroc_kernel

    n = 89_137_319
    g = torch.Generator(device=dev).manual_seed(17)
    t = (torch.rand(n, generator=g, device=dev) < 0.033).to(torch.float32)
    x = torch.randn(n, generator=g, device=dev) + (1.19 * t - 3.89)
    got = binary_auroc_kernel(x, t)
    assert count("curves.auroc_route", route="stream") == 1
    assert {s: count("roc_stream.launches", step=s) for s in ("keys", "sort", "integrate")} == {
        "keys": 1, "sort": 1, "integrate": 1}
    ref = _rank_auroc64(x, t)
    assert abs(float(got) - ref) <= 1e-6 * ref
    assert torch.equal(got, roc_stream.binary_auroc_stream_plain(x, t)[0])
