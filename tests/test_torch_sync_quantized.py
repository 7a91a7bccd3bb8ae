"""The toolkit's quantized lanes in real 2- and 4-process gloo worlds on the
CPU, held to the JAX package's codecs.

Mirrors ``tests/metrics/test_sync_quantized.py``. Each world is the ranks
of ``python -m torcheval_tpu_torch.utils.test_utils.quant_sync_worker``
(killed after 120 s), which sync the same replicas with ``quantize`` off
and on. Integer lanes must come back bit-exact; a quantized float32 lane
must equal, bit for bit, the rank-ordered float32 fold of what the JAX
package's ``q8_decode(q8_encode(...))`` gives for each rank, and lie
within the documented bound (per element, the sum over ranks of
``max|block| / 254``); every sync is two rounds.
"""

import tempfile

import numpy as np
import pytest

from torcheval_tpu.utils import quant as JQ
from torcheval_tpu_torch.utils.test_utils import quant_sync_worker as W

LAUNCH_TIMEOUT_S = 120
WORLDS = (2, 4)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def world(request):
    with tempfile.TemporaryDirectory(prefix="torch_quant_sync_") as outdir:
        yield request.param, W.launch_world(outdir, LAUNCH_TIMEOUT_S, request.param)


def _exact(world_size):
    """The exact rank-ordered folds of the four states."""
    arrays = [W.replica_arrays(r) for r in range(world_size)]
    counts = sum(a[0].astype(np.int64) for a in arrays)
    hits = sum(a[1].astype(np.int64) for a in arrays)
    peak = np.max([a[2] for a in arrays], axis=0)
    fsum = arrays[0][3]
    for a in arrays[1:]:
        fsum = fsum + a[3]
    return counts, hits, peak, fsum


def _q8_fold(fs):
    """The rank-ordered float32 fold of each rank's q8 round trip, through
    the JAX package's codec."""
    acc = None
    for f in fs:
        d = JQ.q8_decode(JQ.q8_encode(f), f.shape)
        acc = d if acc is None else acc + d
    return acc


def _block_bound(fs):
    """Per element: the sum over ranks of its block's ``max|block| / 254``."""
    total = np.zeros(fs[0].shape, np.float64)
    for f in fs:
        blocks = np.abs(f.astype(np.float64)).reshape(-1, JQ.Q8_BLOCK).max(axis=1) / 254.0
        total += np.repeat(blocks, JQ.Q8_BLOCK)
    return total


def test_integer_lanes_are_bit_exact(world):
    w, ranks = world
    counts, hits, peak, _ = _exact(w)
    for res in ranks:
        for key in ("quantized", "mixed", "env_on", "env_int8", "nonfinite"):
            got = res[key]
            assert got["counts"] == counts.tolist() and got["hits"] == hits.tolist()
            assert got["peak"] == peak.tolist()
            assert got["dtypes"] == ["torch.int64", "torch.int64", "torch.int32", "torch.float32"]


def test_raw_sync_is_the_exact_fold(world):
    w, ranks = world
    _, _, _, fsum = _exact(w)
    for res in ranks:
        np.testing.assert_array_equal(np.asarray(res["raw"]["fsum"], np.float32), fsum)


def test_q8_lane_equals_the_jax_codec_and_drifts_within_its_bound(world):
    w, ranks = world
    fs = [W.replica_arrays(r)[3] for r in range(w)]
    want = _q8_fold(fs)
    exact = _exact(w)[3].astype(np.float64)
    bound = _block_bound(fs)
    for res in ranks:
        got = np.asarray(res["quantized"]["fsum"], np.float32)
        np.testing.assert_array_equal(got, want)
        drift = np.abs(got.astype(np.float64) - exact)
        assert drift.max() > 0  # quantized indeed
        # the bound, plus the float32 rounding of the folds themselves
        assert np.all(drift <= bound + 4 * w * np.spacing(np.abs(exact).astype(np.float32)))


def test_quantize_false_opts_out_whatever_the_environment(world):
    w, ranks = world
    _, _, _, fsum = _exact(w)
    for res in ranks:
        got = res["env_on_opt_out"]
        np.testing.assert_array_equal(np.asarray(got["fsum"], np.float32), fsum)
        assert got["payload_bytes"] == res["raw"]["payload_bytes"] == W.RAW_BYTES


@pytest.mark.parametrize("key", ["env_on", "env_int8"])
def test_the_environment_turns_the_lanes_on(world, key):
    for res in world[1]:
        assert res[key]["payload_bytes"] < W.RAW_BYTES // 3
        assert res[key]["fsum"] == res["quantized"]["fsum"]


def test_payload_round_shrinks_at_least_4x(world):
    for res in world[1]:
        assert res["quantized"]["payload_bytes"] * 4 <= res["raw"]["payload_bytes"]


def test_nonfinite_float_lane_falls_back_to_raw_and_counts(world):
    w, ranks = world
    bad = [np.zeros(W.N, np.float32) for _ in range(w)]
    fs = []
    for r in range(w):
        bad[r][r] = np.inf if r % 2 else np.nan
        fs.append(W.replica_arrays(r)[3] + bad[r])
    want = fs[0]
    for f in fs[1:]:
        want = want + f
    for res in ranks:
        got = res["nonfinite"]
        assert got["fallbacks"] == 1  # this rank's float lane, counted once
        np.testing.assert_array_equal(np.asarray(got["fsum"], np.float32), want)
        assert np.isnan(got["fsum"][0]) and np.isinf(got["fsum"][1])


def test_mixed_knob_ranks_interoperate(world):
    # only rank 0 quantizes: its float lane alone carries the q8 error
    w, ranks = world
    fs = [W.replica_arrays(r)[3] for r in range(w)]
    want = JQ.q8_decode(JQ.q8_encode(fs[0]), fs[0].shape)
    for f in fs[1:]:
        want = want + f
    for res in ranks:
        np.testing.assert_array_equal(np.asarray(res["mixed"]["fsum"], np.float32), want)


def test_small_float_states_stay_exact(world):
    w, ranks = world
    assert all(res["small_sum"] == float(sum(3 * (r + 1) for r in range(w))) for res in ranks)


def test_every_sync_is_two_rounds(world):
    for res in world[1]:
        for key in ("raw", "quantized", "mixed", "nonfinite", "env_on", "env_on_opt_out", "env_int8"):
            assert res[key]["rounds"] == 2
        assert res["collection"]["True"]["rounds"] == res["collection"]["False"]["rounds"] == 2


def test_collection_codecs_narrow_bucket_and_q8(world):
    w, ranks = world
    cm = np.zeros((W.CM_CLASSES, W.CM_CLASSES), np.int64)
    inputs, labels_sums = [], []
    for r in range(w):
        (labels, preds), cal, _ = W.collection_arrays(r)
        np.add.at(cm, (labels, preds), 1)
        inputs.append(cal)
    for res in ranks:
        raw, q = res["collection"]["False"], res["collection"]["True"]
        # the confusion matrix (narrow) and the sketch (bucket): exact
        assert raw["cm"] == q["cm"] == cm.tolist()
        assert raw["sketch_counts"] == q["sketch_counts"] and raw["sketch"] == q["sketch"]
        assert raw["wctr"] == q["wctr"]  # the WINDOW lane ships raw
        # the calibration's 256-task sums (q8): the JAX codec's fold
        for i, name in enumerate(("input", "label")):
            parts = [(p * wt).sum(-1, dtype=np.float32) if name == "input" else (c * wt).sum(-1, dtype=np.float32)
                     for p, c, wt in inputs]
            got = np.asarray(q["cal_states"][i], np.float32)
            exact = np.asarray(raw["cal_states"][i], np.float64)
            bound = _block_bound([np.asarray(x, np.float32) for x in parts])
            assert np.all(np.abs(got - exact) <= bound + 1e-5 * np.abs(exact))
        assert q["bytes"] * 20 < raw["bytes"]
