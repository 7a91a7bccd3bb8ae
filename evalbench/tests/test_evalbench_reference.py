"""Each plain reference against a count by brute force on small inputs
with ties."""

import itertools
import math

import pytest
import torch

from evalbench.core.spec import Spec

SPEC = Spec()


def ref(name):
    return SPEC.module("reference", name).reference


def _pair_auc(scores, positive):
    """AUROC as the share of (positive, negative) pairs ordered right, a
    tie counting one half."""
    pos = [s for s, p in zip(scores, positive) if p]
    neg = [s for s, p in zip(scores, positive) if not p]
    won = sum(1.0 if a > b else 0.5 if a == b else 0.0 for a, b in itertools.product(pos, neg))
    return won / (len(pos) * len(neg))


def _tied_scores(n, seed, levels=7):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, levels, (n,), generator=g).to(torch.float32) / levels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_auroc_counts_pairs(seed):
    g = torch.Generator().manual_seed(100 + seed)
    s = _tied_scores(300, seed)
    t = (torch.rand(300, generator=g) < 0.3).to(torch.float32)
    got = float(ref("BinaryAUROC")([s, t], {}, torch.float64))
    assert got == pytest.approx(_pair_auc(s.tolist(), (t > 0).tolist()), abs=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_multiclass_auroc_counts_pairs_per_class(seed):
    g = torch.Generator().manual_seed(seed)
    n, c = 120, 4
    s = torch.randint(0, 5, (n, c), generator=g).to(torch.float32) / 5
    t = torch.arange(c).repeat_interleave(n // c)[torch.randperm(n, generator=g)]
    want = sum(_pair_auc(s[:, k].tolist(), (t == k).tolist()) for k in range(c)) / c
    got = float(ref("MulticlassAUROC")([s, t], {"num_classes": c}, torch.float64))
    assert got == pytest.approx(want, abs=1e-12)


def _scores_with_ties(n, c, seed):
    g = torch.Generator().manual_seed(seed)
    s = torch.randint(0, 4, (n, c), generator=g).to(torch.float32)
    t = torch.randint(0, c, (n,), generator=g)
    return s, t


@pytest.mark.parametrize("k", [1, 2, 3])
def test_accuracy_counts_rows(k):
    s, t = _scores_with_ties(200, 6, 3)
    right = 0
    for row, label in zip(s.tolist(), t.tolist()):
        if k == 1:
            right += row.index(max(row)) == label  # the first largest
        else:
            right += sum(v > row[label] for v in row) < k
    kwargs = {} if k == 1 else {"k": k}
    got = float(ref("MulticlassAccuracy")([s, t], kwargs, torch.float64))
    assert got == pytest.approx(right / 200, abs=1e-15)


def test_confusion_and_macro_f1_count_rows():
    c = 6
    s, t = _scores_with_ties(300, c, 4)
    cm = [[0] * c for _ in range(c)]
    for row, label in zip(s.tolist(), t.tolist()):
        cm[label][row.index(max(row))] += 1
    got = ref("MulticlassConfusionMatrix")([s, t], {"num_classes": c}, torch.float64)
    assert got.tolist() == cm
    f1s = []
    for k in range(c):
        tp = cm[k][k]
        predicted = sum(cm[r][k] for r in range(c))
        actual = sum(cm[k])
        if predicted + actual:
            f1s.append(2 * tp / (predicted + actual))
    got = float(ref("MulticlassF1Score")([s, t], {"num_classes": c, "average": "macro"}, torch.float64))
    assert got == pytest.approx(sum(f1s) / len(f1s), abs=1e-14)


@pytest.mark.parametrize("from_logits", [True, False])
def test_normalized_entropy_sums_rows(from_logits):
    g = torch.Generator().manual_seed(5)
    y = (torch.rand(500, generator=g) < 0.2).to(torch.float32)
    x = torch.randn(500, generator=g)
    if not from_logits:
        x = torch.sigmoid(x)
    ce = 0.0
    for xi, yi in zip(x.tolist(), y.tolist()):
        p = 1 / (1 + math.exp(-xi)) if from_logits else xi
        ce -= yi * math.log(p) + (1 - yi) * math.log(1 - p)
    base = y.mean().item()
    h = -base * math.log(base) - (1 - base) * math.log(1 - base)
    got = ref("BinaryNormalizedEntropy")([x, y], {"from_logits": from_logits}, torch.float64)
    assert got.shape == (1,)
    assert float(got) == pytest.approx(ce / 500 / h, rel=1e-6)


def test_ctr_and_calibration_sum_rows():
    g = torch.Generator().manual_seed(6)
    y = (torch.rand(400, generator=g) < 0.1).to(torch.float32)
    p = torch.rand(400, generator=g)
    w = torch.rand(400, generator=g)
    ctr = ref("ClickThroughRate")([y, w], {}, torch.float64)
    assert float(ctr) == pytest.approx(sum(a * b for a, b in zip(y.tolist(), w.tolist())) / sum(w.tolist()), rel=1e-6)
    assert float(ref("ClickThroughRate")([y], {}, torch.float64)) == pytest.approx(y.mean().item(), rel=1e-6)
    cal = ref("WeightedCalibration")([p, y, w], {}, torch.float64)
    want = sum(a * b for a, b in zip(p.tolist(), w.tolist())) / sum(a * b for a, b in zip(y.tolist(), w.tolist()))
    assert float(cal) == pytest.approx(want, rel=1e-6)

