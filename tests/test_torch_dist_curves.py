"""The port's distributed exact curves (``ops/dist_curves.py``) and the curve
metrics' routes behind ``ShardedEvaluator``, in real 4-process gloo worlds
on the CPU, against the JAX package.

Mirrors ``tests/ops/test_dist_curves.py``. Two worlds for the module, each
four processes of ``python -m
torcheval_tpu_torch.utils.test_utils.dist_curves_worker``, killed after
their own timeout (120 s): ``kernels`` runs the ``sharded_*`` functions on
each rank's block of every case, ``evaluator`` the four curve metrics
through ``ShardedEvaluator``. The oracle is the JAX function itself on the
same global rows, sharded over the first 4 of the 8 forced CPU devices
(each rank's block is the same device's block): values within atol 1e-8 /
rtol 1e-5, error-row counts exactly, sketch counts exactly. Ragged splits
(a rank with no rows among them) are held to the one-process port. NaN
scores are held to the one-process port only: the two packages sort them
to opposite ends (``tests/test_torch_prc.py``).
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torcheval_tpu.metrics as J
from torcheval_tpu.ops import dist_curves as JD
from torcheval_tpu.parallel import ShardedEvaluator as JaxShardedEvaluator
from torcheval_tpu_torch.metrics import (
    BinaryAUPRC,
    BinaryAUROC,
    MulticlassAccuracy,
    MulticlassAUPRC,
    MulticlassAUROC,
)
from torcheval_tpu_torch.ops import dist_curves as dc
from torcheval_tpu_torch.ops.curves import (
    binary_auprc_kernel,
    binary_auroc_kernel,
    multiclass_auprc_kernel,
    multiclass_auroc_kernel,
)
from torcheval_tpu_torch.sketch.histogram import mc_score_hist_fold, score_hist_fold
from torcheval_tpu_torch.utils.test_utils import dist_curves_worker as W

LAUNCH_TIMEOUT_S = 120
RTOL, ATOL = 1e-5, 1e-8
JAX_FNS = {"auroc": JD.sharded_binary_auroc, "auprc": JD.sharded_binary_auprc,
           "mc_auroc": JD.sharded_multiclass_auroc, "mc_auprc": JD.sharded_multiclass_auprc}
PORT_FNS = {"auroc": binary_auroc_kernel, "auprc": binary_auprc_kernel,
            "mc_auroc": multiclass_auroc_kernel, "mc_auprc": multiclass_auprc_kernel}
CASES = {name: (which, batches) for name, which, batches in W.kernel_cases()}


def _mesh():
    return Mesh(np.asarray(jax.devices()[: W.WORLD]), ("data",))


def _shard(mesh, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))


def _jax_dist(which, batches):
    mesh = _mesh()
    v, err = JAX_FNS[which]([_shard(mesh, s) for s, _ in batches], [_shard(mesh, t) for _, t in batches],
                            mesh=mesh, axis="data")
    return np.asarray(v, np.float64).reshape(-1), int(err)


def _port_one_process(which, s, t):
    return PORT_FNS[which](torch.from_numpy(s), torch.from_numpy(t)).double().reshape(-1).numpy()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def kernels():
    with tempfile.TemporaryDirectory(prefix="torch_dist_curves_") as outdir:
        yield W.launch_world("kernels", outdir, LAUNCH_TIMEOUT_S)


def _write_jax_states(outdir):
    """Each rank's block of the state batch, as a JAX raw-cache BinaryAUROC
    state dict."""
    (s, t), = W.evaluator_batches("state")
    for r in range(W.WORLD):
        m = J.BinaryAUROC()
        m.update(jnp.asarray(W.even_block(s, r)), jnp.asarray(W.even_block(t, r)))
        # a cache state as its one array, or left out when empty
        sd = {k: v[0] if isinstance(v, list) else v for k, v in m.state_dict().items() if
              not isinstance(v, list) or v}
        np.savez(os.path.join(outdir, f"jax_state_rank{r}.npz"), **{k: np.asarray(v) for k, v in sd.items()})


@pytest.fixture(scope="module")
def evaluator():
    with tempfile.TemporaryDirectory(prefix="torch_dist_eval_") as outdir:
        _write_jax_states(outdir)
        yield W.launch_world("evaluator", outdir, LAUNCH_TIMEOUT_S)


# ------------------------------------------------------- the kernel cases
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_the_jax_function(kernels, name):
    which, batches = CASES[name]
    want, want_err = _jax_dist(which, batches)
    for res in kernels:
        got = res["even"][name]
        assert got["error_rows"] == want_err
        if want_err == 0:
            _close(got["value"], want)


@pytest.mark.parametrize("name", ["auroc_nan", "auprc_nan", "mc_auroc_nan", "mc_auprc_nan"])
def test_error_channel_trips_on_nan(kernels, name):
    assert all(res["even"][name]["error_rows"] > 0 for res in kernels)


@pytest.mark.parametrize("name", ["auroc_all_equal", "auroc_massive_ties", "mc_auroc_one_tied_class"])
def test_four_even_ranks_hold_any_skew(kernels, name):
    # a bucket's capacity, ceil(4 * n_local / 4), is a whole even block
    assert all(res["even"][name]["error_rows"] == 0 for res in kernels)


CAPACITY_CASES = {name: (which, batches) for name, which, batches in W.capacity_cases()}


@pytest.mark.parametrize("name", sorted(CAPACITY_CASES))
def test_overflow_count_equals_the_jax_function_exactly(kernels, monkeypatch, name):
    which, batches = CAPACITY_CASES[name]
    monkeypatch.setattr(JD, "DIST_CAPACITY_FACTOR", W.LOW_CAPACITY_FACTOR)
    want, want_err = _jax_dist(which, batches)
    assert want_err > 0
    for res in kernels:
        got = res["low_capacity"][name]
        assert got["error_rows"] == want_err


def test_ragged_overflow_is_counted_exactly(kernels):
    # ranks 2 and 3 hold 400 and 163 equal scores against a capacity of 150
    assert [res["ragged"]["auroc_overflow"]["error_rows"] for res in kernels] == [263] * W.WORLD


def test_nan_rows_count_exactly(kernels):
    # two NaN rows and no overflow: the count is the NaN rows alone
    assert [res["even"]["auroc_nan"]["error_rows"] for res in kernels] == [2] * W.WORLD
    assert [res["even"]["mc_auroc_nan"]["error_rows"] for res in kernels] == [2] * W.WORLD


@pytest.mark.parametrize("name", ["auroc_ties_multi_batch", "mc_auroc_ties", "auprc_signed_zeros"])
def test_clean_data_equals_the_one_process_port(kernels, name):
    which, batches = CASES[name]
    s = np.concatenate([b[0] for b in batches])
    t = np.concatenate([b[1] for b in batches])
    want = _port_one_process(which, s, t)
    for res in kernels:
        assert res["even"][name]["error_rows"] == 0
        _close(res["even"][name]["value"], want)


def test_signed_zeros_share_a_tie_group(kernels):
    _, batches = CASES["auroc_signed_zeros"]
    (s, t), = batches
    want = _port_one_process("auroc", s, t)
    split = _port_one_process("auroc", np.where(s == 0, np.copysign(1e-30, s), s), t)
    assert abs(float(want[0]) - float(split[0])) > 1e-4  # the zeros' order matters here
    for res in kernels:
        _close(res["even"]["auroc_signed_zeros"]["value"], want)


def test_degenerate_targets_guard(kernels):
    for res in kernels:
        assert res["even"]["auroc_all_positive"]["value"] == [0.5]
        assert res["even"]["auroc_all_negative"]["value"] == [0.5]
        assert res["even"]["auprc_all_negative"]["value"] == [0.0]
        _close(res["even"]["auprc_all_positive"]["value"], [1.0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_collectives_are_five_whatever_the_classes_and_rows(kernels, name):
    # splitter all-reduce and integral all-reduce; count and totals
    # all-gathers; one all-to-all
    assert all(res["even"][name]["collectives"] == [2, 2, 1] for res in kernels)


@pytest.mark.parametrize("name", ["auroc_ties_multi_batch", "mc_auroc_ties", "mc_auroc_two_batches"])
def test_send_bytes_are_the_rows_that_entered_the_exchange(kernels, name):
    which, batches = CASES[name]
    classes = batches[0][0].shape[1] if batches[0][0].ndim == 2 else 1
    rows = sum(s.shape[0] // W.WORLD for s, _ in batches)
    for res in kernels:
        assert res["even"][name]["send_bytes"] == 8 * classes * rows


@pytest.mark.parametrize("name", sorted(CASES))
def test_quantize_changes_nothing(kernels, name):
    # the quantized routes move no value and no error row here: every bin
    # of these small histograms sums below 256, so the bf16 sum is exact and
    # the splitters stay put; the int8 sum may move them, which leaves the
    # values within rtol 1e-5 (bit-equal where the scores are quantized)
    for res in kernels:
        raw = res["even"][name]
        for mode in W.QUANTIZE_MODES:
            got = raw[mode]
            assert got["error_rows"] == raw["error_rows"]
            if raw["error_rows"]:
                continue
            if mode == "bf16" or "uniform" not in name:
                assert got["bit_equal"], (mode, got["value"], raw["value"])
            _close(got["value"], raw["value"])


QUANTIZED_JAX_CASES = ["auroc_ties_multi_batch", "auprc_ties", "mc_auroc_ties", "mc_auprc_ties"]


@pytest.mark.parametrize("mode", W.QUANTIZE_MODES)
@pytest.mark.parametrize("name", QUANTIZED_JAX_CASES)
def test_quantized_values_equal_the_jax_quantized_functions(kernels, name, mode):
    which, batches = CASES[name]
    mesh = _mesh()
    v, err = JAX_FNS[which]([_shard(mesh, s) for s, _ in batches], [_shard(mesh, t) for _, t in batches],
                            mesh=mesh, axis="data", quantize=mode)
    for res in kernels:
        got = res["even"][name][mode]
        assert got["error_rows"] == int(err) == 0
        _close(got["value"], np.asarray(v, np.float64).reshape(-1))


@pytest.mark.parametrize("name", sorted(CASES))
def test_quantized_collectives_as_documented(kernels, name):
    # bf16: the exact lanes' all-reduce joins the five; int8: the qpsum's
    # all-to-all and all-gather take the histogram all-reduce's place
    for res in kernels:
        assert res["even"][name]["bf16"]["collectives"] == [3, 2, 1]
        assert res["even"][name]["int8"]["collectives"] == [2, 3, 2]


@pytest.mark.parametrize("mode", ["False", "bf16", "int8"])
def test_an_abstaining_rank_stops_every_route_after_one_collective(kernels, mode):
    assert all(res["abstain"][mode] == {"none": True, "collectives": [1, 0, 0]} for res in kernels)


@pytest.mark.parametrize("name", ["auroc_ties_multi_batch", "auprc_ties", "mc_auroc_ties", "mc_auroc_two_batches"])
def test_quantized_rows_are_five_and_six_eighths(kernels, name):
    raw_row = 8
    row = 6 if name.startswith("mc_") else 5
    for res in kernels:
        got = res["even"][name]
        for mode in W.QUANTIZE_MODES:
            assert got[mode]["send_bytes"] * raw_row == got["send_bytes"] * row


@pytest.mark.parametrize("name", ["auroc_nan", "auprc_nan", "mc_auroc_nan", "mc_auprc_nan"])
def test_quantized_error_channel_still_trips_on_nan(kernels, name):
    want = 2
    for res in kernels:
        assert [res["even"][name][m]["error_rows"] for m in W.QUANTIZE_MODES] == [want, want]


@pytest.mark.parametrize("name", [c[0] for c in W.ragged_cases()] + ["auroc_overflow"])
def test_exact_lanes_hold_on_ragged_ranks(kernels, name):
    # capacity (from the exact row total), NaN and overflow counts are the
    # raw route's in every mode, and the values one process's
    for res in kernels:
        raw = res["ragged"][name]
        for mode in W.QUANTIZE_MODES:
            got = res["ragged"][f"{name}/{mode}"]
            assert got["error_rows"] == raw["error_rows"]
            if not raw["error_rows"]:
                _close(got["value"], raw["value"])


@pytest.mark.parametrize("name", sorted(CAPACITY_CASES))
def test_quantized_overflow_still_trips(kernels, name):
    # a lossy histogram may move the splitters, and with them the overflow
    # count; the channel trips in every mode, exactly as raw with bf16 here
    for res in kernels:
        got = res["low_capacity"][name]
        assert got["bf16"] == got["error_rows"] > 0 and got["int8"] > 0


def test_the_environment_picks_the_int8_route(kernels):
    name = W.kernel_cases()[0][0]
    for res in kernels:
        assert res["env_int8"] == {"collectives": [2, 3, 2],
                                   "send_bytes": res["even"][name]["int8"]["send_bytes"]}


@pytest.mark.parametrize("name", [c[0] for c in W.ragged_cases()])
def test_ragged_split_and_an_empty_rank_equal_one_process(kernels, name):
    which, (s, t) = {n: (w, d) for n, w, d in W.ragged_cases()}[name]
    want = _port_one_process(which, s, t)
    for res in kernels:
        assert res["ragged"][name]["error_rows"] == 0
        _close(res["ragged"][name]["value"], want)


def test_mesh_axis_group(kernels):
    for res in kernels:
        got, want = res["mesh_axis_group"], res["even"]["auroc_ties_multi_batch"]
        assert got["error_rows"] == want["error_rows"] == 0
        assert got["value"] == want["value"]


def _jax_sketch(mesh, s, t, bits, classes=None):
    tp, fp, nan = JD.sharded_sketch_counts([_shard(mesh, s)], [_shard(mesh, t)], mesh=mesh,
                                           axis="data", bucket_bits=bits, num_classes=classes)
    return np.asarray(tp).tolist(), np.asarray(fp).tolist(), int(nan)


def test_sketch_counts_equal_the_jax_function_exactly(kernels):
    (s, t), (x, y) = W.sketch_data()
    mesh = _mesh()
    want_b = _jax_sketch(mesh, s, t, W.SKETCH_BITS)
    want_m = _jax_sketch(mesh, x, y, W.MC_SKETCH_BITS, x.shape[1])
    for res in kernels:
        got = res["sketch"]["even"]
        assert got["binary"] == list(want_b)
        assert got["multiclass"] == list(want_m)
        assert got["collectives"] == [2, 0, 0]  # one all-reduce a call


def test_ragged_sketch_counts_equal_one_process(kernels):
    (s, t), (x, y) = W.sketch_data()
    n = sum(W.RAGGED_SPLIT)
    s, t = np.resize(s, n), np.resize(t, n)
    x, y = np.resize(x, (n, x.shape[1])), np.resize(y, n)
    tp, fp, nan = score_hist_fold(torch.from_numpy(s), torch.from_numpy(t), W.SKETCH_BITS)
    mtp, mfp, mnan = mc_score_hist_fold(torch.from_numpy(x), torch.from_numpy(y), W.MC_SKETCH_BITS,
                                        x.shape[1])
    for res in kernels:
        got = res["sketch"]["ragged"]
        assert got["binary"] == [tp.tolist(), fp.tolist(), int(nan)]
        assert got["multiclass"] == [mtp.tolist(), mfp.tolist(), int(mnan)]


def test_order_key_is_the_jax_key_with_the_sign_bit_flipped():
    x = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, -np.nan, 3.4e38, -3.4e38, 0.5,
                  2.0**-126, -(2.0**-126)], np.float32)
    want = np.asarray(JD._desc_key(jnp.asarray(x))).astype(np.uint32)
    got = dc.order_key(torch.from_numpy(x)).numpy().view(np.uint32) ^ np.uint32(0x80000000)
    np.testing.assert_array_equal(got, want)
    bins = dc.splitter_bins(dc.order_key(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(bins, want >> 16)


def test_subnormal_scores_keep_their_order():
    # XLA on the CPU compares subnormals as zero, so the JAX key ties them
    # with 0.0; the port's key orders them as torch.sort does, and so the
    # one-process port does
    x = np.array([2.0**-126, 1e-45, 0.0, -1e-45, -(2.0**-126)], np.float32)
    key = dc.order_key(torch.from_numpy(x)).numpy()
    assert (np.diff(key) > 0).all()


def test_without_a_world_the_functions_are_one_rank():
    which, batches = CASES["mc_auroc_two_batches"]
    v, err = dc.sharded_multiclass_auroc([torch.from_numpy(s) for s, _ in batches],
                                         [torch.from_numpy(t) for _, t in batches])
    s = np.concatenate([b[0] for b in batches])
    t = np.concatenate([b[1] for b in batches])
    assert err == 0
    _close(v.numpy(), _port_one_process(which, s, t))


# ------------------------------------------------------ the evaluator route
def _jax_evaluator(members, batches):
    ev = JaxShardedEvaluator(members, mesh=_mesh())
    for s, t in batches:
        ev.update(jnp.asarray(s), jnp.asarray(t))
    out = ev.compute()
    return {k: np.asarray(v, np.float64).reshape(-1) for k, v in out.items()}


def _port_local(members, batches):
    for s, t in batches:
        for m in members.values():
            m.update(torch.from_numpy(s), torch.from_numpy(t))
    return {k: m.compute().double().reshape(-1).numpy() for k, m in members.items()}


def _assert_values(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


def test_evaluator_binary_takes_the_dist_route(evaluator):
    batches = W.evaluator_batches("binary")
    want = _jax_evaluator({"auroc": J.BinaryAUROC(), "auprc": J.BinaryAUPRC()}, batches)
    local = _port_local({"auroc": BinaryAUROC(device="cpu"), "auprc": BinaryAUPRC(device="cpu")}, batches)
    for res in evaluator:
        for key in ("binary", "binary_again"):
            got = res[key]
            assert got["routes"] == {"dist/binary": 2}
            assert got["gather_rounds"] == 0
            _assert_values(got["values"], want)
            _assert_values(got["values"], local)
        assert res["state_unchanged"]


def test_evaluator_multiclass_takes_the_dist_route(evaluator):
    batches = W.evaluator_batches("multiclass")
    want = _jax_evaluator({"auroc": J.MulticlassAUROC(num_classes=5, average=None),
                           "auprc": J.MulticlassAUPRC(num_classes=5, average=None),
                           "macro": J.MulticlassAUROC(num_classes=5)}, batches)
    for res in evaluator:
        assert res["multiclass"]["routes"] == {"dist/multiclass": 3}
        assert res["multiclass"]["gather_rounds"] == 0
        _assert_values(res["multiclass"]["values"], want)


@pytest.mark.parametrize("kind", ["overflow", "nan", "skew"])
def test_every_rank_falls_back_together_and_equals_one_process(evaluator, kind):
    batches = W.evaluator_batches(kind)
    local = _port_local({"auroc": BinaryAUROC(device="cpu"), "auprc": BinaryAUPRC(device="cpu")}, batches)
    for res in evaluator:
        got = res[kind]
        if kind == "skew":  # at 4 even ranks the ties fit their bucket
            assert got["routes"] == {"dist/binary": 2} and got["gather_rounds"] == 0
            _assert_values(got["values"], local)
            continue
        assert got["routes"] == {"fused/binary": 2}  # the gather route's computes
        assert got["gather_rounds"] == 2  # one collection sync
        _assert_values(got["values"], local)
    if kind != "nan":
        want = _jax_evaluator({"auroc": J.BinaryAUROC(), "auprc": J.BinaryAUPRC()}, batches)
        _assert_values(evaluator[0][kind]["values"], want)


def test_a_summary_on_one_rank_vetoes_the_route(evaluator):
    s, t = W.tied(sum(W.SUMMARY_SPLIT), 125)
    want = _port_local({"auroc": BinaryAUROC(device="cpu")}, [(s, t)])
    for res in evaluator:
        got = res["summary_on_one_rank"]
        assert got["routes"] == {"fused/binary": 1}
        assert got["gather_rounds"] == 2
        _assert_values(got["values"], want)


def test_empty_ranks_and_no_rows(evaluator):
    want = _port_local({"auroc": BinaryAUROC(device="cpu"), "auprc": BinaryAUPRC(device="cpu")},
                       [W.tied(37, 126)])
    for res in evaluator:
        assert res["empty_rank"]["routes"] == {"dist/binary": 2}
        _assert_values(res["empty_rank"]["values"], want)
        assert res["no_rows"]["routes"] == {"dist/binary": 2, "dist/multiclass": 1}
        assert res["no_rows"]["values"] == {"auroc": [0.5], "auprc": [0.0], "mc": [0.5]}


def test_curve_member_beside_a_synced_member(evaluator):
    batches = W.evaluator_batches("multiclass")
    want = _port_local({"acc": MulticlassAccuracy(num_classes=5, device="cpu"),
                        "auroc": MulticlassAUROC(num_classes=5, device="cpu")}, batches)
    for res in evaluator:
        assert res["mixed"]["routes"] == {"dist/multiclass": 1}
        assert res["mixed"]["gather_rounds"] == 2
        _assert_values(res["mixed"]["values"], want)


def test_merged_cache_takes_the_dist_route(evaluator):
    first = W.evaluator_batches("binary")[:1]
    want = _port_local({"metric": BinaryAUROC(device="cpu")}, first + [W.tied(999, 127)])
    for res in evaluator:
        assert res["merged"]["routes"] == {"dist/binary": 1}
        _assert_values(res["merged"]["values"], want)


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_approx_members_take_the_sketch_all_reduce(evaluator, kind):
    batches = W.evaluator_batches(kind)
    if kind == "binary":
        local = {"auroc": BinaryAUROC(approx=True, device="cpu"), "auprc": BinaryAUPRC(approx=1024, device="cpu")}
        jax_members = {"auroc": J.BinaryAUROC(approx=True), "auprc": J.BinaryAUPRC(approx=1024)}
    else:
        local = {"auroc": MulticlassAUROC(num_classes=5, average=None, approx=True, device="cpu"),
                 "auprc": MulticlassAUPRC(num_classes=5, approx=True, device="cpu")}
        jax_members = {"auroc": J.MulticlassAUROC(num_classes=5, average=None, approx=True),
                       "auprc": J.MulticlassAUPRC(num_classes=5, approx=True)}
    want = _port_local(local, batches)
    jax_want = _jax_evaluator(jax_members, batches)
    for res in evaluator:
        got = res[f"approx_{kind}"]
        assert got["routes"] == {f"sketch/{kind}": 2}
        assert got["gather_rounds"] == 0
        for k in want:  # the same counts through the same function
            np.testing.assert_array_equal(got["values"][k], want[k])
        _assert_values(got["values"], jax_want)


def test_jax_written_state_computes_through_the_dist_route(evaluator):
    (s, t), = W.evaluator_batches("state")
    m = J.BinaryAUROC()
    m.update(jnp.asarray(s), jnp.asarray(t))
    want = np.asarray(m.compute(), np.float64).reshape(-1)
    for res in evaluator:
        assert res["jax_state"]["routes"] == {"dist/binary": 1}
        _close(res["jax_state"]["values"]["metric"], want)


def test_multi_axis_data_groups_each_run_their_exchange(evaluator):
    binary = W.evaluator_batches("binary")[:2]
    mc = W.evaluator_batches("multiclass")
    jb, jm = J.BinaryAUROC(), J.MulticlassAUROC(num_classes=5, average=None)
    for (s, t), (x, y) in zip(binary, mc):
        jb.update(jnp.asarray(s), jnp.asarray(t))
        jm.update(jnp.asarray(x), jnp.asarray(y))
    want = {"auroc": np.asarray(jb.compute(), np.float64).reshape(-1),
            "mc": np.asarray(jm.compute(), np.float64)}
    for rank, res in enumerate(evaluator):
        got = res["multi_axis"]
        assert got["data_ranks"] == [rank % 2, rank % 2 + 2]
        assert got["routes"] == {"dist/binary": 1, "dist/multiclass": 1}
        assert got["gather_rounds"] == 0
        _assert_values(got["values"], want)
