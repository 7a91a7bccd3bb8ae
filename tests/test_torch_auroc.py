"""The port's AUROC/AUPRC, and the slice as a whole, against the JAX package.

The same numpy inputs, made from a seed, go through ``torcheval_tpu`` and
``torcheval_tpu_torch`` (``device="cpu"``, where the compaction kernel's
plain version runs). The JAX side's compaction runs either on its two-sort
path or on its Pallas kernel in interpret mode (the JAX package's own
switch, ``jax_auroc_mod.STREAM_COMPACTION = "interpret"``, restored
afterwards). The port's one compaction pipeline is also held fold by fold
against its own two-sort oracle (``ops/summary.py::compact_counts``), bit
for bit.
AUROC/AUPRC/accuracy values agree within rtol 1e-5, atol 1e-8 (the
trapezoid and step sums run in another order); counts agree exactly.
"""

import copy
import pickle

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.metrics.classification.auroc as jax_auroc_mod
import torcheval_tpu_torch.metrics.classification.auroc as auroc_mod
from torcheval_tpu.metrics.functional import binary_auprc as jax_binary_auprc
from torcheval_tpu.metrics.functional import binary_auroc as jax_binary_auroc
from torcheval_tpu_torch.metrics import (
    BinaryAUPRC,
    BinaryAUROC,
    MulticlassAccuracy,
)
from torcheval_tpu_torch.metrics.functional import binary_auprc, binary_auroc
from torcheval_tpu_torch.ops.summary import PAD_SCORE, compact_counts, compact_counts_fast
from torcheval_tpu_torch.utils.jax_state import load_jax_state_dict, numpy_state_dict
from torcheval_tpu_torch.utils.test_utils.obs_counts import launches, recording


@pytest.fixture
def obs_on():
    """The obs registry on (and reset) for a test that counts launches,
    folds or rounds: the registry is the port's one counter."""
    with recording():
        yield


RTOL, ATOL = 1e-5, 1e-8
N, BATCH, THRESHOLD = 4000, 500, 1200  # the threshold fires three times


def _close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)


def _scores(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = ((rng.random(n) * 300).astype(np.int32) / 300.0).astype(np.float32)  # ties
    x[rng.integers(0, n, 20)] = -np.inf
    t = (rng.random(n) < 0.35).astype(np.float32)
    return x, t


@pytest.fixture
def jax_mode(request):
    saved = jax_auroc_mod.STREAM_COMPACTION
    jax_auroc_mod.STREAM_COMPACTION = request.param
    try:
        yield request.param
    finally:
        jax_auroc_mod.STREAM_COMPACTION = saved


def test_functional_matches_jax():
    x, t = _scores()
    _close(binary_auroc(x, t), jax_binary_auroc(x, t))
    _close(binary_auprc(x, t), jax_binary_auprc(x, t))
    with pytest.raises(ValueError, match="same shape"):
        binary_auroc(x[:10], t[:11])


@pytest.mark.parametrize("jax_mode", ["auto", "interpret"], indirect=True)
@pytest.mark.parametrize("threshold", [None, THRESHOLD])
@pytest.mark.parametrize("cls", ["BinaryAUROC", "BinaryAUPRC"])
def test_streaming_matches_jax(cls, threshold, jax_mode):
    x, t = _scores(seed=1)
    ours = getattr(auroc_mod, cls)(compaction_threshold=threshold, device="cpu")
    theirs = getattr(J, cls)(compaction_threshold=threshold)
    for i in range(0, N, BATCH):
        ours.update(x[i:i + BATCH], t[i:i + BATCH])
        theirs.update(x[i:i + BATCH], t[i:i + BATCH])
    if threshold is not None:
        assert ours.summary_scores and theirs.summary_scores
    _close(ours.compute(), theirs.compute())
    # the compacted summary equals JAX's row for row
    for name in ("summary_scores", "summary_tp", "summary_fp", "inputs"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert len(a) == len(b)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u.numpy(), np.asarray(v))


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("threshold", [None, THRESHOLD], ids=str)
@pytest.mark.parametrize("seed", [1, 2])
def test_stream_compaction_is_bit_equal_to_the_two_sort_fold_by_fold(seed, threshold, nan):
    """Every fold a compacting binary metric makes over ``_scores`` (ties,
    -inf; with ``nan``, a NaN score in each fold): the raw batches and the
    carried summary, padded and trimmed as the metric pads and trims them,
    compacted by the metrics' pipeline (``compact_counts_fast``) and by the
    two-sort oracle, bit for bit. With no threshold the stream folds once,
    as a merge's compaction of the whole cache would."""
    x, t = _scores(seed=seed)
    if nan:
        x[[3, 1700, N - 1]] = np.nan
    raw_s, raw_t, summary = [], [], ([], [], [])
    folds = nan_dropped = 0
    for i in range(0, N, BATCH):
        raw_s.append(torch.from_numpy(x[i:i + BATCH]))
        raw_t.append(torch.from_numpy(t[i:i + BATCH]))
        if i + BATCH < N and (threshold is None or sum(len(a) for a in raw_s) < threshold):
            continue
        s, tp, fp = auroc_mod._combined_counts(raw_s, raw_t, *summary)
        pad = auroc_mod._pad_cap(len(s)) - len(s)
        cols = (torch.cat([s, s.new_full((pad,), PAD_SCORE)]),
                torch.cat([tp, tp.new_zeros(pad)]), torch.cat([fp, fp.new_zeros(pad)]))
        want, got = compact_counts(*cols), compact_counts_fast(*cols)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))  # NaN padding bits too
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == w.dtype and torch.equal(g, w)
        keep = min(len(cols[0]), auroc_mod._pad_cap(max(int(want[3]), 1)))
        summary = tuple([c[:keep]] for c in want[:3])
        raw_s, raw_t = [], []
        folds += 1
        nan_dropped += int(want[4])
    assert folds == (1 if threshold is None else 3)
    assert nan_dropped == (3 if nan else 0)


def test_presorted_compute_and_refold():
    x, t = _scores(seed=2)
    m = BinaryAUROC(compaction_threshold=BATCH, device="cpu")
    for i in range(0, N, BATCH):
        m.update(x[i:i + BATCH], t[i:i + BATCH])
    assert m._presorted_summary() is not None  # ended on a compaction
    _close(m.compute(), jax_binary_auroc(x, t))
    for _ in range(2):
        m._compact()  # refold the NaN-padded summary
    _close(m.compute(), jax_binary_auroc(x, t))


def test_nan_scores_raise_at_compute():
    x = np.linspace(0, 1, 40).astype(np.float32)
    x[3] = np.nan
    t = (x > 0.5).astype(np.float32)
    m = BinaryAUROC(compaction_threshold=10, device="cpu")
    m.update(x, t)
    for _ in range(2):  # a poisoned state keeps raising
        with pytest.raises(ValueError, match="NaN scores reached"):
            m.compute()
    m.reset()
    assert float(m.compute()) == 0.5


def test_empty_and_checks():
    assert float(BinaryAUROC(device="cpu").compute()) == 0.5
    assert float(BinaryAUPRC(device="cpu").compute()) == 0.0
    with pytest.raises(ValueError, match="compaction_threshold"):
        BinaryAUROC(compaction_threshold=0, device="cpu")
    with pytest.raises(ValueError, match="one-dimensional"):
        BinaryAUROC(device="cpu").update(np.zeros((2, 2)), np.zeros((2, 2)))


# ------------------------------------------------------- the slice as a whole
def _slice_stream(seed=3):
    """Batches of the slice's main path at a small size: 5-class and
    1000-class scores with labels, and binary scores with targets."""
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(8):
        s5 = rng.random((BATCH, 5)).astype(np.float32)
        l5 = rng.integers(0, 5, BATCH)
        s1k = rng.random((BATCH, 1000)).astype(np.float32)
        l1k = rng.integers(0, 1000, BATCH)
        x = ((rng.random(BATCH) * 700).astype(np.int32) / 700.0).astype(np.float32)
        t = (l5 == 0).astype(np.float32)
        batches.append((s5, l5, s1k, l1k, x, t))
    return batches


def _ours():
    return {
        "micro": MulticlassAccuracy(num_classes=5, device="cpu"),
        "macro": MulticlassAccuracy(average="macro", num_classes=1000, device="cpu"),
        "auroc": BinaryAUROC(compaction_threshold=THRESHOLD, device="cpu"),
        "auprc": BinaryAUPRC(compaction_threshold=THRESHOLD, device="cpu"),
    }


def _theirs():
    return {
        "micro": J.MulticlassAccuracy(num_classes=5),
        "macro": J.MulticlassAccuracy(average="macro", num_classes=1000),
        "auroc": J.BinaryAUROC(compaction_threshold=THRESHOLD),
        "auprc": J.BinaryAUPRC(compaction_threshold=THRESHOLD),
    }


def _feed(metrics, batches):
    for s5, l5, s1k, l1k, x, t in batches:
        metrics["micro"].update(s5, l5)
        metrics["macro"].update(s1k, l1k)
        metrics["auroc"].update(x, t)
        metrics["auprc"].update(x, t)
    return metrics


@pytest.mark.parametrize("jax_mode", ["interpret"], indirect=True)
def test_slice_matches_jax(jax_mode):
    batches = _slice_stream()
    ours, theirs = _feed(_ours(), batches), _feed(_theirs(), batches)
    assert len(ours["auroc"].summary_scores) == 1  # compactions fired
    for name in ours:
        _close(ours[name].compute(), theirs[name].compute())
    jmacro = theirs["macro"].state_dict()
    np.testing.assert_array_equal(ours["macro"].num_correct.numpy(), np.asarray(jmacro["num_correct"]))


def test_slice_merge_equals_single_stream():
    batches = _slice_stream(seed=4)
    whole = _feed(_ours(), batches)
    parts = [_feed(_ours(), batches[:3]), _feed(_ours(), batches[3:5]), _feed(_ours(), batches[5:])]
    for name in whole:
        for p in parts[1:]:
            p[name]._prepare_for_merge_state()
        parts[0][name].merge_state([p[name] for p in parts[1:]])
        _close(parts[0][name].compute(), whole[name].compute())


def test_slice_state_dict_round_trip_copy_and_pickle():
    batches = _slice_stream(seed=5)
    ours = _feed(_ours(), batches[:5])
    for name, m in ours.items():
        want = float(m.compute())
        fresh = _ours()[name]
        fresh.load_state_dict(m.state_dict())
        _close(fresh.compute(), want)
        _close(copy.deepcopy(m).compute(), want)
        _close(pickle.loads(pickle.dumps(m)).compute(), want)
        _close(m.to("cpu").compute(), want)
        # the copies are independent of the original's later updates
        clone = copy.deepcopy(m)
        _feed({k: (m if k == name else _ours()[k]) for k in ours}, batches[5:])
        _close(clone.compute(), want)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_carried_across(direction):
    batches = _slice_stream(seed=6)
    reference = _feed(_theirs(), batches)
    first, second = (_theirs, _ours) if direction == "jax_to_port" else (_ours, _theirs)
    head = _feed(first(), batches[:4])
    tail = second()
    for name in tail:
        if direction == "jax_to_port":
            state = {
                k: [np.asarray(a) for a in v] if isinstance(v, list) else np.asarray(v)
                for k, v in head[name].state_dict().items()
            }
            load_jax_state_dict(tail[name], state)
        else:
            tail[name].load_state_dict(numpy_state_dict(head[name]))
    _feed(tail, batches[4:])
    for name in tail:
        _close(tail[name].compute(), reference[name].compute())


def test_compaction_launch_count_untouched_on_cpu(obs_on):
    before = launches("stream_compact")
    _feed(_ours(), _slice_stream(seed=7))
    assert launches("stream_compact") == before  # the plain version ran
