"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip
without one. Run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``
(``--noconftest``: ``tests/conftest.py`` sets up JAX, which the card's
machine need not have). ``chip_smoke.py`` repeats these checks at the main
path's full shapes.
"""

import pytest
import torch

from torcheval_tpu_torch.ops.hist import hist, hist_plain
from torcheval_tpu_torch.ops.stream_compact import (
    compact_summary_rows,
    compact_summary_rows_plain,
    stream_compact,
    stream_compact_plain,
)
from torcheval_tpu_torch.ops.summary import compact_counts, compact_counts_fast
from torcheval_tpu_torch.metrics import NDCG, ReciprocalRank, TopKMultilabelAccuracy
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
