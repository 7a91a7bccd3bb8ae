"""The port's ranking and retrieval metrics against the JAX package, on the
CPU.

The same numpy inputs, made from a seed, go through ``torcheval_tpu`` and
``torcheval_tpu_torch`` (``device="cpu"``, where the top-k kernel's plain
version stands in for it). Scores compare within rtol 1e-5 and atol 1e-8,
with NaN where JAX gives NaN; counts compare exactly.
"""

import importlib

import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.metrics.functional as JF
import torcheval_tpu_torch.metrics as P
import torcheval_tpu_torch.metrics.functional as PF
from torcheval_tpu_torch.ops.topk import topk_kernel
from torcheval_tpu_torch.utils.jax_state import load_jax_state_dict, numpy_state_dict

RTOL, ATOL = 1e-5, 1e-8
N, L = 48, 1300  # past the top-k engine's dense threshold of 1024 labels


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
        rtol=RTOL, atol=ATOL, equal_nan=True,
    )


def _scores(seed, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        return rng.integers(0, 6, (N, L)).astype(np.float32)
    return rng.random((N, L), dtype=np.float32)


def _relevance(seed, graded=False):
    rng = np.random.default_rng(seed + 100)
    rel = (rng.random((N, L)) < 0.01).astype(np.float32)
    if graded:
        rel *= rng.integers(1, 4, (N, L)).astype(np.float32)
    rel[0] = 0.0  # a row with no relevant label: NaN per sample
    rel[1, :3] = 1.0  # the top of the ideal ranking ties
    return rel


def _class_targets(seed):
    return np.random.default_rng(seed + 200).integers(0, L, N)


# -------------------------------------------------------------- functional
RETRIEVAL = ["recall_at_k", "map_at_k", "ndcg_at_k", "retrieval_hit_rate"]


@pytest.mark.parametrize("fn", RETRIEVAL)
@pytest.mark.parametrize("k", [None, 1, 5, 128, 5000])
@pytest.mark.parametrize("ties", [False, True])
def test_retrieval_functional_matches_jax(fn, k, ties):
    s = _scores(k or 0, ties)
    t = _relevance(k or 0, graded=fn == "ndcg_at_k")
    got = getattr(PF, fn)(s, t, k=k)
    assert got.dtype == torch.float32
    _close(got, getattr(JF, fn)(s, t, k=k))


@pytest.mark.parametrize("fn", RETRIEVAL)
@pytest.mark.parametrize("method", ["dense", "prune", "kernel"])
def test_retrieval_topk_methods_agree_with_jax(fn, method):
    s, t = _scores(1, ties=True), _relevance(1, graded=True)
    _close(getattr(PF, fn)(s, t, k=10, topk_method=method), getattr(JF, fn)(s, t, k=10))


@pytest.mark.parametrize("k", [None, 1, 3, 40, 5000])
@pytest.mark.parametrize("ties", [False, True])
def test_hit_rate_and_reciprocal_rank_match_jax(k, ties):
    s, tgt = _scores(2, ties), _class_targets(2)
    for ours, theirs in ((PF.hit_rate, JF.hit_rate), (PF.reciprocal_rank, JF.reciprocal_rank)):
        got = ours(s, tgt, k=k)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(theirs(s, tgt, k=k)))


@pytest.mark.parametrize("ties", [False, True])
def test_reciprocal_rank_engine_branch(monkeypatch, ties):
    # auto is dense on the CPU, so force the truncated-rank branch, which the
    # card takes at L > 1024, and hold it to the full comparison
    # (the package re-exports the function under the module's name)
    rr_module = importlib.import_module(
        "torcheval_tpu_torch.metrics.functional.ranking.reciprocal_rank"
    )
    monkeypatch.setattr(
        rr_module, "_pick_method", lambda l, k, dtype, method, device: "kernel"
    )
    s, tgt = _scores(3, ties), _class_targets(3)
    for k in (1, 5, 40):
        got = PF.reciprocal_rank(s, tgt, k=k).numpy()
        y = np.take_along_axis(s, tgt[:, None], axis=-1)
        rank = (s > y).sum(-1)
        want = np.where(rank >= k, 0.0, 1.0 / (rank + 1)).astype(np.float32)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(JF.reciprocal_rank(s, tgt, k=k)))


def test_frequency_and_num_collisions_match_jax():
    rng = np.random.default_rng(4)
    freq = rng.random(300).astype(np.float32) * 10
    for k in (0.0, 2.5, 10.0):
        np.testing.assert_array_equal(
            PF.frequency_at_k(freq, k).numpy(), np.asarray(JF.frequency_at_k(freq, k))
        )
    for ids in (rng.integers(0, 20, 400), rng.integers(-5, 5, 50).astype(np.int32), np.arange(7)):
        got = PF.num_collisions(ids)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(JF.num_collisions(ids)))


def test_functional_validation():
    s, tgt = _scores(5), _class_targets(5)
    with pytest.raises(ValueError, match="target indices"):
        PF.hit_rate(s, np.full(N, L))
    with pytest.raises(ValueError, match="target indices"):
        PF.reciprocal_rank(s, np.full(N, -1))
    with pytest.raises(ValueError, match="minibatch"):
        PF.hit_rate(s, tgt[:-1])
    with pytest.raises(ValueError, match="positive"):
        PF.hit_rate(s, tgt, k=0)
    with pytest.raises(ValueError, match="shape"):
        PF.ndcg_at_k(s, s[:, :10])
    with pytest.raises(ValueError, match="positive int"):
        PF.recall_at_k(s, s, k=0)
    with pytest.raises(ValueError, match="method"):
        PF.map_at_k(s, s, k=3, topk_method="pallas")
    with pytest.raises(ValueError, match="one-dimensional"):
        PF.frequency_at_k(s, 1.0)
    with pytest.raises(ValueError, match="negative"):
        PF.frequency_at_k(s[0], -1.0)
    with pytest.raises(ValueError, match="integer"):
        PF.num_collisions(s[0])


# ------------------------------------------------------------------ classes
MEAN_CLASSES = ["NDCG", "MAP", "RecallAtK"]
CACHE_CLASSES = ["HitRate", "ReciprocalRank"]


def _stream(name, seed):
    s = _scores(seed, ties=seed % 2 == 1)
    t = _class_targets(seed) if name in CACHE_CLASSES else _relevance(seed, graded=name == "NDCG")
    return [(s[i:i + 16], t[i:i + 16]) for i in range(0, N, 16)]


def _feed(metric, batches):
    for s, t in batches:
        metric.update(s, t)
    return metric


@pytest.mark.parametrize("name", MEAN_CLASSES + CACHE_CLASSES)
@pytest.mark.parametrize("k", [None, 5])
def test_streaming_class_matches_jax(name, k):
    batches = _stream(name, 6 + (k or 0))
    ours = _feed(getattr(P, name)(k=k, device="cpu"), batches)
    theirs = _feed(getattr(J, name)(k=k), batches)
    _close(ours.compute(), theirs.compute())
    if name in MEAN_CLASSES:
        folded = theirs.state_dict()
        assert ours.num_valid.dtype == torch.int32 and ours.score_sum.dtype == torch.float32
        assert int(ours.num_valid) == int(folded["num_valid"])


@pytest.mark.parametrize("name", MEAN_CLASSES + CACHE_CLASSES)
def test_empty_compute_matches_jax(name):
    got, want = getattr(P, name)(device="cpu").compute(), getattr(J, name)().compute()
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("name", MEAN_CLASSES + CACHE_CLASSES)
def test_merge_state_equals_one_stream(name):
    batches = _stream(name, 9)
    whole = _feed(getattr(P, name)(k=5, device="cpu"), batches)
    a = _feed(getattr(P, name)(k=5, device="cpu"), batches[:1])
    b = _feed(getattr(P, name)(k=5, device="cpu"), batches[1:])
    a.merge_state([b])
    _close(a.compute(), whole.compute())
    theirs = _feed(getattr(J, name)(k=5), batches[:1])
    theirs.merge_state([_feed(getattr(J, name)(k=5), batches[1:])])
    _close(a.compute(), theirs.compute())


@pytest.mark.parametrize("name", MEAN_CLASSES + CACHE_CLASSES)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_carried_across(name, direction):
    batches = _stream(name, 10)
    reference = _feed(getattr(J, name)(k=5), batches)
    if direction == "jax_to_port":
        head = _feed(getattr(J, name)(k=5), batches[:2])
        state = {
            key: [np.asarray(a) for a in v] if isinstance(v, list) else np.asarray(v)
            for key, v in head.state_dict().items()
        }
        tail = getattr(P, name)(k=5, device="cpu")
        load_jax_state_dict(tail, state)
    else:
        head = _feed(getattr(P, name)(k=5, device="cpu"), batches[:2])
        tail = getattr(J, name)(k=5)
        tail.load_state_dict(numpy_state_dict(head))
    _feed(tail, batches[2:])
    _close(tail.compute(), reference.compute())


def test_state_dict_reset_and_topk_method_check():
    batches = _stream("NDCG", 11)
    m = _feed(P.NDCG(k=5, device="cpu"), batches)
    sd = m.state_dict()
    m.update(*batches[0])
    restored = P.NDCG(k=5, device="cpu")
    restored.load_state_dict(sd)
    _close(restored.compute(), _feed(P.NDCG(k=5, device="cpu"), batches).compute())
    restored.reset()
    assert int(restored.num_valid) == 0
    for name in MEAN_CLASSES:
        with pytest.raises(ValueError, match="topk_method"):
            getattr(P, name)(k=5, topk_method="pallas", device="cpu")
        with pytest.raises(ValueError, match="positive int"):
            getattr(P, name)(k=0, device="cpu")
    for name in CACHE_CLASSES:
        with pytest.raises(ValueError, match="positive"):
            getattr(P, name)(k=0, device="cpu")


@pytest.mark.parametrize("method", ["dense", "prune", "kernel"])
def test_ndcg_forced_methods_launch_nothing_on_cpu(method):
    batches = _stream("NDCG", 12)
    before = topk_kernel.launches
    ours = _feed(P.NDCG(k=10, topk_method=method, device="cpu"), batches)
    _close(ours.compute(), _feed(J.NDCG(k=10), batches).compute())
    assert topk_kernel.launches == before
