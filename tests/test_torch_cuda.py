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
