"""The port's one-vs-all multiclass AUROC and AUPRC (``ops/curves.py``, the
functional forms, the per-class compaction of ``ops/summary.py`` and the
compacting class metrics) against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through both packages
(``device="cpu"``, where the compaction kernel's plain version runs).
Values agree within rtol 1e-5, atol 1e-8 (the trapezoid and step sums run
in another order); summary counts and per-class unique counts are equal
exactly. The port's fold is one stream compaction over the flattened rows
(the kernel's route on the card); fold by fold over the class metrics'
streams it is bit-equal to the batched two-sort
(``ops/summary.py::compact_count_rows``), the oracle it is tested against.
"""

import copy

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.metrics.functional as JF
import torcheval_tpu_torch.metrics.classification.auroc as auroc_mod
from torcheval_tpu_torch.metrics import MulticlassAUPRC, MulticlassAUROC
from torcheval_tpu_torch.metrics.functional import multiclass_auprc, multiclass_auroc
from torcheval_tpu_torch.ops.summary import (
    PAD_SCORE,
    compact_count_rows,
    compact_count_rows_fast,
    compact_counts,
)
from torcheval_tpu_torch.utils.jax_state import load_jax_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils import NUM_TOTAL_UPDATES, MetricClassTester

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-8
C = 5
AVERAGES = ["macro", "none", None]
METRICS = {
    "auroc": (MulticlassAUROC, J.MulticlassAUROC, multiclass_auroc, JF.multiclass_auroc),
    "auprc": (MulticlassAUPRC, J.MulticlassAUPRC, multiclass_auprc, JF.multiclass_auprc),
}


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=RTOL, atol=ATOL
    )


def _data(seed, n=300, classes=C, levels=50):
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, levels, (n, classes)) / levels).astype(np.float32)  # ties
    x[rng.integers(0, n, 6), rng.integers(0, classes, 6)] = -np.inf
    t = rng.integers(0, classes, n)
    return x, t


# --------------------------------------------------------------- functional
@pytest.mark.parametrize("name", list(METRICS))
@pytest.mark.parametrize("average", AVERAGES, ids=str)
def test_functional_matches_jax(name, average):
    x, t = _data(seed=1)
    t[t == 3] = 2  # class 3 never labelled: AUROC 0.5, AUPRC 0.0
    port, ref = METRICS[name][2:]
    got = port(x, t, num_classes=C, average=average)
    _close(got, ref(x, t, num_classes=C, average=average))


def test_a_tie_never_crosses_class_rows():
    # class 0's lowest score equals class 1's highest
    rng = np.random.default_rng(2)
    x = np.stack([0.5 + rng.integers(0, 5, 60) / 10, rng.integers(0, 6, 60) / 10], axis=1).astype(np.float32)
    x[0, 0], x[1, 1] = 0.5, 0.5
    t = rng.integers(0, 2, 60)
    for name in METRICS:
        port, ref = METRICS[name][2:]
        _close(port(x, t, num_classes=2, average=None), ref(x, t, num_classes=2, average=None))


def test_parameter_checks_match_jax():
    with pytest.raises(ValueError, match="average"):
        multiclass_auroc(torch.zeros(4, 3), torch.zeros(4), num_classes=3, average="micro")
    with pytest.raises(ValueError, match="at least 2"):
        MulticlassAUPRC(num_classes=1, device=CPU)
    with pytest.raises(ValueError, match="num_sample, num_classes"):
        multiclass_auprc(torch.zeros(4, 2), torch.zeros(4), num_classes=3)


# --------------------------------------------------------- row compaction
def _rows(seed, classes=4, m=64):
    rng = np.random.default_rng(seed)
    s = (rng.integers(0, 12, (classes, m)) / 8).astype(np.float32)
    s[:, -5:] = PAD_SCORE  # padding rows of a summary
    s[0, 3] = np.nan  # a NaN sample: dropped and counted
    s[1, 7], s[1, 8] = -0.0, 0.0
    s[2, :] = s[2, 0]  # one tie group a whole row
    s[3, -1] = s[2, 0]  # the next row ends in the same score
    tp = rng.integers(0, 3, (classes, m)).astype(np.int32)
    fp = rng.integers(0, 3, (classes, m)).astype(np.int32)
    tp[:, -5:] = 0
    fp[:, -5:] = 0
    tp[:, 3] = np.maximum(tp[:, 3], 1)
    return torch.from_numpy(s), torch.from_numpy(tp), torch.from_numpy(fp)


@pytest.mark.parametrize("seed", [3, 4])
def test_fast_row_compaction_is_bit_equal_to_the_two_sort(seed):
    s, tp, fp = _rows(seed)
    a = compact_count_rows(s, tp, fp)
    b = compact_count_rows_fast(s, tp, fp)
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))  # NaN padding bits too
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # each row is the binary compaction of that row
    for c in range(s.shape[0]):
        one = compact_counts(s[c], tp[c], fp[c])
        n = int(one[3])
        assert n == int(a[3][c])
        assert torch.equal(one[0][:n], a[0][c, :n]) and torch.equal(one[1], a[1][c])
        assert torch.equal(one[2], a[2][c])
    assert int(a[4]) == int(tp[0, 3] + fp[0, 3])


# (seed, rows, batch, threshold, nan): the class metrics' streams, each with
# and without NaN scores, and the NaN test's stream
MC_FOLD_STREAMS = [
    *[(seed, NUM_TOTAL_UPDATES * 40, 40, threshold, nan)
      for seed in (5, 9) for threshold in (None, 100, 250) for nan in (False, True)],
    (8, 60, 20, 30, True),
]


@pytest.mark.parametrize("seed, n, batch, threshold, nan", MC_FOLD_STREAMS)
def test_row_compaction_is_bit_equal_to_the_two_sort_fold_by_fold(seed, n, batch, threshold, nan):
    """Every fold a compacting multiclass metric makes over ``_data`` (ties,
    -inf; with ``nan``, two NaN entries): the raw batches and the carried
    ``(K, C)`` summary as ``(C, M)`` columns, padded and trimmed as the
    metric pads and trims them, compacted by the metrics' pipeline
    (``compact_count_rows_fast``) and by the batched two-sort, bit for bit.
    With no threshold the stream folds once."""
    x, t = _data(seed=seed, n=n)
    if nan:
        x[3, 1] = x[10, 2] = np.nan
    raw_s, raw_t, summary = [], [], ([], [], [])
    folds = nan_dropped = 0
    for i in range(0, n, batch):
        raw_s.append(torch.from_numpy(x[i:i + batch]))
        raw_t.append(torch.from_numpy(t[i:i + batch]))
        if i + batch < n and (threshold is None or sum(len(a) for a in raw_s) < threshold):
            continue
        s, tp, fp = auroc_mod._mc_combined_counts(raw_s, raw_t, *summary, C)
        pad = (C, auroc_mod._pad_cap(s.shape[1]) - s.shape[1])
        cols = (torch.cat([s, s.new_full(pad, PAD_SCORE)], 1),
                torch.cat([tp, tp.new_zeros(pad)], 1), torch.cat([fp, fp.new_zeros(pad)], 1))
        want, got = compact_count_rows(*cols), compact_count_rows_fast(*cols)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))  # NaN padding bits too
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == w.dtype and torch.equal(g, w)
        keep = min(cols[0].shape[1], auroc_mod._pad_cap(max(int(want[3].max()), 1)))
        summary = tuple([c.T[:keep]] for c in want[:3])
        raw_s, raw_t = [], []
        folds += 1
        nan_dropped += int(want[4])
    assert (folds == 1) == (threshold is None)
    assert nan_dropped == (2 if nan else 0)


# ------------------------------------------------------------ class metrics
@pytest.mark.parametrize("name", list(METRICS))
@pytest.mark.parametrize("average", ["macro", None], ids=str)
@pytest.mark.parametrize("threshold", [None, 100, 250], ids=str)
def test_class_matches_jax(name, average, threshold):
    port_cls, ref_cls = METRICS[name][:2]
    x, t = _data(seed=5, n=NUM_TOTAL_UPDATES * 40)
    port = port_cls(num_classes=C, average=average, compaction_threshold=threshold, device=CPU)
    ref = ref_cls(num_classes=C, average=average, compaction_threshold=threshold)
    for i in range(NUM_TOTAL_UPDATES):
        port.update(x[40 * i:40 * i + 40], t[40 * i:40 * i + 40])
        ref.update(x[40 * i:40 * i + 40], t[40 * i:40 * i + 40])
    _close(port.compute(), ref.compute())
    got, want = port.state_dict(), ref.state_dict()
    assert len(got["summary_scores"]) == len(want["summary_scores"])
    for name_ in ("summary_tp", "summary_fp"):
        for g, w in zip(got[name_], want[name_]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got["summary_scores"], want["summary_scores"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))  # NaN padding in both


class TestMulticlassCurveClasses(MetricClassTester):
    def test_every_metric_and_threshold(self):
        x, t = _data(seed=6, n=NUM_TOTAL_UPDATES * 24, levels=30)
        xs, ts = x.reshape(NUM_TOTAL_UPDATES, 24, C), t.reshape(NUM_TOTAL_UPDATES, 24)
        for name, (port_cls, _, _, ref_fn) in METRICS.items():
            for threshold in (None, 64):
                with self.subTest(name=name, threshold=threshold):
                    self.run_class_implementation_tests(
                        metric=port_cls(num_classes=C, compaction_threshold=threshold, device=CPU),
                        state_names={"inputs", "targets", "summary_scores", "summary_tp",
                                     "summary_fp", "summary_nan_dropped"},
                        update_kwargs={"input": torch.from_numpy(xs), "target": torch.from_numpy(ts)},
                        compute_result=torch.tensor(float(ref_fn(x, t, num_classes=C))),
                        atol=ATOL,
                        rtol=RTOL,
                    )


@pytest.mark.parametrize("name", list(METRICS))
def test_empty_and_degenerate_states_match_jax(name):
    port_cls, ref_cls = METRICS[name][:2]
    for average in ("macro", None):
        _close(port_cls(num_classes=3, average=average, device=CPU).compute(),
               ref_cls(num_classes=3, average=average).compute())
    # one class only: the others have no positives
    x, _ = _data(seed=7, n=50, classes=3)
    t = np.zeros(50, np.int64)
    port = port_cls(num_classes=3, average=None, compaction_threshold=20, device=CPU)
    ref = ref_cls(num_classes=3, average=None, compaction_threshold=20)
    for i in range(0, 50, 10):
        port.update(x[i:i + 10], t[i:i + 10])
        ref.update(x[i:i + 10], t[i:i + 10])
    _close(port.compute(), ref.compute())


def test_nan_scores_that_reach_a_compaction_raise():
    x, t = _data(seed=8, n=60)
    x[3, 1] = x[10, 2] = np.nan
    m = MulticlassAUROC(num_classes=C, compaction_threshold=30, device=CPU)
    for i in range(0, 60, 20):
        m.update(x[i:i + 20], t[i:i + 20])
    with pytest.raises(ValueError, match="2 per-class score entry"):
        m.compute()


@pytest.mark.parametrize("name", list(METRICS))
def test_merge_and_state_carried_both_ways(name):
    port_cls, ref_cls = METRICS[name][:2]
    x, t = _data(seed=9, n=400)
    whole = ref_cls(num_classes=C, compaction_threshold=90)
    for i in range(0, 400, 50):
        whole.update(x[i:i + 50], t[i:i + 50])
    a = port_cls(num_classes=C, compaction_threshold=90, device=CPU)
    b = port_cls(num_classes=C, compaction_threshold=90, device=CPU)
    j = ref_cls(num_classes=C, compaction_threshold=90)
    for i in range(0, 200, 50):
        a.update(x[i:i + 50], t[i:i + 50])
        j.update(x[i:i + 50], t[i:i + 50])
    for i in range(200, 400, 50):
        b.update(x[i:i + 50], t[i:i + 50])
    merged = copy.deepcopy(a).merge_state([b])
    _close(merged.compute(), whole.compute())
    # JAX first half -> port second half, and back
    there = port_cls(num_classes=C, compaction_threshold=90, device=CPU)
    load_jax_state_dict(there, {k: v if isinstance(v, list) else np.asarray(v)
                                for k, v in j.state_dict().items()})
    back = ref_cls(num_classes=C, compaction_threshold=90)
    back.load_state_dict(numpy_state_dict(a))
    for i in range(200, 400, 50):
        there.update(x[i:i + 50], t[i:i + 50])
        back.update(x[i:i + 50], t[i:i + 50])
    _close(there.compute(), whole.compute())
    _close(back.compute(), whole.compute())
