"""The exact binary AUROC's stream route (``ops/roc_stream.py``) on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``). Here: the
route's arithmetic in plain PyTorch (the order keys, the stable sort, the
int64 integration over tie-group ends) against the composition of
``ops/curves.py`` and the JAX package; which inputs ``binary_auroc_kernel``
sends to the route (a 1-D score column off the CPU) and which keep the
composition (the CPU, ``(C, N)`` rows, other score types, targets whose
int32 cast is not 0 or 1), each call counted in
``curves.auroc_route{route=}``; which raw caches reach the route as their
parts (``binary_auroc_parts``); and the launch path with the library
faked: one key-pass launch a cache part at its offset, the sort's buffers,
the integration, the flag's read, each C entry call one
``roc_stream.launches{step=}``.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.ops.curves as jc
from torcheval_tpu_torch import _build
from torcheval_tpu_torch.metrics import BinaryAUROC, MulticlassAUROC
from torcheval_tpu_torch.ops import curves, roc_stream
from torcheval_tpu_torch.ops.curves import (
    auroc_composition,
    binary_auroc_kernel,
    binary_auroc_parts,
)
from torcheval_tpu_torch.utils.test_utils.obs_counts import count, launches, recording

TILE = 4096  # csrc/roc_stream.cu's rows a tile


@pytest.fixture
def obs_on():
    with recording():
        yield


def _case(name, n, seed):
    """numpy float32 scores and {0, 1} float32 targets of a named case."""
    rng = np.random.default_rng(seed)
    t = (rng.random(n) < 0.3).astype(np.float32)
    if name == "heavy_ties":
        x = rng.integers(0, 8, n) / 8.0
    elif name == "one_group":
        x = np.full(n, 0.25)
    elif name == "straddling":  # groups of 37 rows across the tiles' edges
        x = rng.permutation(np.arange(n) // 37).astype(np.float64)
    elif name == "integer_valued":
        x = rng.integers(-1000, 1000, n).astype(np.float64)
    elif name == "signed_zero":
        x = np.array([0.0, -0.0, 1.0, -1.0])[rng.integers(0, 4, n)]
    elif name == "infinities":
        x = rng.standard_normal(n)
        x[rng.random(n) < 0.2] = np.inf
        x[rng.random(n) < 0.2] = -np.inf
    elif name == "all_positive":
        x, t = rng.standard_normal(n), np.ones(n, np.float32)
    elif name == "all_negative":
        x, t = rng.standard_normal(n), np.zeros(n, np.float32)
    else:  # distinct
        x = rng.standard_normal(n)
    return x.astype(np.float32), t


CASES = ["heavy_ties", "one_group", "straddling", "integer_valued", "signed_zero",
         "infinities", "all_positive", "all_negative", "distinct"]


# ------------------------------------------------------------ the order keys
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_order_keys_order_scores_descending_with_nan_last(dtype):
    x = torch.tensor([1.0, -1.0, 0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                      -float("nan"), 3.5, 1e-30, -1e-30, 65504.0]).to(dtype)
    keys = roc_stream.order_keys_plain(x)
    assert keys.dtype == torch.int64 and bool(((keys >= 0) & (keys <= 0xFFFFFFFF)).all())
    nan = torch.isnan(x)
    assert bool((keys[nan] == roc_stream.NAN_KEY).all())
    assert bool((keys[~nan] < roc_stream.NAN_KEY).all())
    real, rk = x[~nan].float(), keys[~nan]
    for i in range(real.numel()):
        for j in range(real.numel()):
            a, b = float(real[i]), float(real[j])
            assert (rk[i] < rk[j]) == (a > b) and (rk[i] == rk[j]) == (a == b)


def test_order_keys_tie_exactly_where_scores_do():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(20_000).astype(np.float32)
    x[::3] = x[1::3][: x[::3].size]  # many exact ties
    keys = roc_stream.order_keys_plain(torch.from_numpy(x)).numpy()
    order = np.argsort(keys, kind="stable")
    assert np.all(np.diff(x[order]) <= 0)
    assert np.unique(keys).size == np.unique(x).size


# ------------------------------------------- the plain arithmetic of the route
@pytest.mark.parametrize("n", [1, 2, TILE - 1, TILE + 1, 3 * TILE + 5])
@pytest.mark.parametrize("case", CASES)
def test_stream_arithmetic_equals_the_composition_and_jax(case, n):
    x, t = _case(case, n, n)
    got, area, p = roc_stream.binary_auroc_stream_plain(torch.from_numpy(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and p == int(t.sum())
    want = float(auroc_composition(torch.from_numpy(x), torch.from_numpy(t)))
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)
    jax_value = float(jc.binary_auroc_kernel(jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(float(got), jax_value, rtol=1e-5, atol=1e-8)
    q = n - p
    assert float(got) == (0.5 if p * q == 0 else np.float32(area / (2.0 * p * q)))


@pytest.mark.parametrize("at", ["first", "middle", "last", "scattered", "all"])
def test_stream_arithmetic_keeps_nan_rows_in_input_order(at):
    """Every NaN row is a group of its own after every real score, in input
    order, as the composition's stable sort leaves them."""
    n = 2 * TILE + 9
    x, t = _case("heavy_ties", n, 2)
    t[::2] = 1.0
    where = {"first": slice(0, 3), "middle": slice(n // 2, n // 2 + 3),
             "last": slice(n - 3, n), "scattered": slice(0, n, 5), "all": slice(0, n)}[at]
    x[where] = np.nan
    got = roc_stream.binary_auroc_stream_plain(torch.from_numpy(x), torch.from_numpy(t))[0]
    want = float(auroc_composition(torch.from_numpy(x), torch.from_numpy(t)))
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)
    # the order of the NaN rows moves the value: reversed, it is another
    if at in ("scattered", "all"):
        idx = np.flatnonzero(np.isnan(x))
        t2 = t.copy()
        t2[idx] = t[idx][::-1]
        other = roc_stream.binary_auroc_stream_plain(torch.from_numpy(x), torch.from_numpy(t2))[0]
        assert float(other) == pytest.approx(
            float(auroc_composition(torch.from_numpy(x), torch.from_numpy(t2))), rel=1e-6)


@pytest.mark.parametrize("tdtype", [torch.bool, torch.int64, torch.int32, torch.uint8,
                                    torch.float32, torch.float64])
def test_stream_arithmetic_takes_every_binary_target_type(tdtype):
    x, t = _case("integer_valued", TILE + 3, 3)
    tt = torch.from_numpy(t).to(tdtype)
    got = roc_stream.binary_auroc_stream_plain(torch.from_numpy(x), tt)[0]
    want = float(auroc_composition(torch.from_numpy(x), tt))
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("values", [[0.0, 1.0, 2.0], [0.0, 1.0, -1.0], [0, 1, 7]])
def test_stream_arithmetic_refuses_targets_whose_cast_is_not_binary(values):
    x, _ = _case("distinct", 100, 4)
    t = torch.tensor(values)[torch.arange(100) % 3]
    assert roc_stream.binary_auroc_stream_plain(torch.from_numpy(x), t) is None


def test_stream_arithmetic_takes_a_list_of_parts():
    x, t = _case("heavy_ties", 5000, 5)
    xs, ts = torch.from_numpy(x), torch.from_numpy(t)
    whole = roc_stream.binary_auroc_stream_plain(xs, ts)
    parts = roc_stream.binary_auroc_stream_plain([xs[:7], xs[7:4100], xs[4100:]],
                                                 [ts[:7], ts[7:4100], ts[4100:]])
    assert torch.equal(whole[0], parts[0]) and whole[1:] == parts[1:]


def test_stream_arithmetic_of_nothing_is_one_half():
    got, area, p = roc_stream.binary_auroc_stream_plain(torch.empty(0), torch.empty(0))
    assert float(got) == 0.5 and area == p == 0


# ------------------------------------------------------------- the dispatch
@pytest.fixture
def fake_route(monkeypatch):
    """Tensors that the wrappers take for the card's, and a stream route
    that records its calls and answers 0.25 (None when told to)."""
    calls = []

    def route(scores, targets):
        calls.append((scores, targets))
        return None if route.refuse else torch.tensor(0.25)

    route.refuse = False
    route.calls = calls
    monkeypatch.setattr(_build, "runs_plain", lambda t: False)
    monkeypatch.setattr(roc_stream, "binary_auroc_stream", route)
    return route


def test_the_cpu_keeps_the_composition(obs_on):
    x, t = _case("heavy_ties", 3000, 6)
    got = binary_auroc_kernel(torch.from_numpy(x), torch.from_numpy(t))
    want = float(jc.binary_auroc_kernel(jnp.asarray(x), jnp.asarray(t)))
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-8)
    assert count("curves.auroc_route", route="composition") == 1
    assert count("curves.auroc_route", route="stream") == 0


@pytest.mark.parametrize("sdtype", [torch.float32, torch.float16, torch.bfloat16])
def test_a_score_column_off_the_cpu_takes_the_stream(fake_route, obs_on, sdtype):
    x, t = torch.rand(50).to(sdtype), torch.rand(50) < 0.5
    assert float(binary_auroc_kernel(x, t)) == 0.25
    ((scores, targets),) = fake_route.calls
    assert scores[0] is x and targets[0] is t
    assert count("curves.auroc_route", route="stream") == 1
    assert count("curves.auroc_route", route="composition") == 0


@pytest.mark.parametrize("what", ["float64", "int32", "rows", "mixed_parts"])
def test_other_inputs_keep_the_composition(fake_route, obs_on, what):
    x, t = torch.rand(64), (torch.rand(64) < 0.5).float()
    args = {
        "float64": (x.double(), t),
        "int32": ((x * 10).int(), t),
        "rows": (x.reshape(4, 16), t.reshape(4, 16)),
        "mixed_parts": ([x[:10], x[10:].double()], [t[:10], t[10:]]),
    }[what]
    parts = isinstance(args[0], list)
    got = (binary_auroc_parts if parts else binary_auroc_kernel)(*args)
    assert fake_route.calls == []
    assert count("curves.auroc_route", route="composition") == 1
    assert count("curves.auroc_route", route="stream") == 0
    if what != "rows":
        s = torch.cat(args[0]) if parts else args[0]
        tt = torch.cat(args[1]) if parts else args[1]
        want = float(jc.binary_auroc_kernel(jnp.asarray(s.double().numpy()), jnp.asarray(tt.float().numpy())))
        np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("what", ["mixed_targets", "ragged_part"])
def test_parts_unfit_to_read_in_place_reach_the_stream_concatenated(fake_route, obs_on, what):
    """Parts the route cannot read as they lie (targets of two types, a
    target part of another length than its scores') are concatenated, as
    the JAX package concatenates its cache, and the one column then takes
    the route like any other."""
    x, t = torch.rand(64), (torch.rand(64) < 0.5).float()
    args = {
        "mixed_targets": ([x[:10], x[10:]], [t[:10], t[10:].bool()]),
        "ragged_part": ([x[:10], x[10:]], [t[:11], t[11:]]),
    }[what]
    assert float(binary_auroc_parts(*args)) == 0.25
    ((scores, targets),) = fake_route.calls
    assert len(scores) == len(targets) == 1
    assert torch.equal(scores[0], x) and torch.equal(targets[0], torch.cat(args[1]))
    assert launches("binary_auroc_kernel") == 1
    assert count("curves.auroc_route", route="stream") == 1


def test_targets_the_stream_refuses_take_the_composition(fake_route, obs_on):
    x, _ = _case("heavy_ties", 500, 7)
    t = torch.tensor([0.0, 1.0, 2.0])[torch.arange(500) % 3]
    fake_route.refuse = True
    got = binary_auroc_kernel(torch.from_numpy(x), t)
    assert len(fake_route.calls) == 1
    assert count("curves.auroc_route", route="composition") == 1
    assert count("curves.auroc_route", route="stream") == 0
    assert torch.equal(got, auroc_composition(torch.from_numpy(x), t))


def test_multiclass_rows_never_reach_the_stream(fake_route, obs_on):
    x, t = torch.rand(300, 4), torch.randint(0, 4, (300,))
    m = MulticlassAUROC(num_classes=4, average=None, device="cpu")
    m.update(x, t)
    got = m.compute()
    assert fake_route.calls == [] and got.shape == (4,)
    assert count("curves.auroc_route", route="composition") == 1
    assert count("curves.auroc_route", route="stream") == 0


def test_a_raw_cache_reaches_the_stream_as_its_parts(fake_route, obs_on):
    """``BinaryAUROC.compute()`` over a raw cache hands the route the cache's
    own tensors, with no concatenation, once a ``compute()``."""
    m = BinaryAUROC(device="cpu")
    batches = [(torch.rand(n), torch.rand(n) < 0.3) for n in (10, 1, 33)]
    for x, t in batches:
        m.update(x, t)
    assert float(m.compute()) == 0.25
    ((scores, targets),) = fake_route.calls
    assert len(scores) == 3 and all(a is b for a, b in zip(scores, m.inputs))
    assert all(a is b for a, b in zip(targets, m.targets))
    assert count("curves.auroc_route", route="stream") == 1
    # parts on the route are no watched entry: no binary_auroc_kernel call
    assert launches("binary_auroc_kernel") == 0


def test_a_one_part_cache_goes_to_the_watched_entry_as_it_lies(fake_route, obs_on):
    """One update's cache reaches ``binary_auroc_kernel`` (one ``jit.calls``,
    as the JAX package's call of its concatenated cache) with the cache's
    own tensor, not a copy."""
    m = BinaryAUROC(device="cpu")
    m.update(torch.rand(40), torch.rand(40) < 0.3)
    assert float(m.compute()) == 0.25
    ((scores, targets),) = fake_route.calls
    assert scores[0] is m.inputs[0] and targets[0] is m.targets[0]
    assert launches("binary_auroc_kernel") == 1
    assert count("curves.auroc_route", route="stream") == 1


def test_refused_parts_take_the_composition_once(fake_route, obs_on):
    """Parts whose targets the route refuses are not tried again: one route
    call, then the composition of their concatenation."""
    x, _ = _case("heavy_ties", 90, 8)
    xs = torch.from_numpy(x)
    t = torch.tensor([0.0, 1.0, 2.0])[torch.arange(90) % 3]
    fake_route.refuse = True
    got = binary_auroc_parts([xs[:30], xs[30:]], [t[:30], t[30:]])
    assert len(fake_route.calls) == 1
    assert count("curves.auroc_route", route="composition") == 1
    assert count("curves.auroc_route", route="stream") == 0
    assert torch.equal(got, auroc_composition(xs, t))


@pytest.mark.parametrize("sizes", [(7,), (3, 1, 40)])
def test_the_cpu_concatenates_parts_into_the_watched_entry(obs_on, sizes):
    """On the CPU a raw cache of any number of parts reaches
    ``binary_auroc_kernel`` once, concatenated, and equals the JAX
    package."""
    rng = np.random.default_rng(9)
    xs = [rng.integers(0, 5, n).astype(np.float32) / 5 for n in sizes]
    ts = [(rng.random(n) < 0.4).astype(np.float32) for n in sizes]
    got = binary_auroc_parts([torch.from_numpy(a) for a in xs], [torch.from_numpy(b) for b in ts])
    want = float(jc.binary_auroc_kernel(jnp.asarray(np.concatenate(xs)), jnp.asarray(np.concatenate(ts))))
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-8)
    assert launches("binary_auroc_kernel") == 1
    assert count("curves.auroc_route", route="composition") == 1


def test_a_compacted_summary_keeps_the_counts_kernels(obs_on):
    m = BinaryAUROC(compaction_threshold=64, device="cpu")
    for _ in range(3):
        m.update(torch.rand(50), torch.rand(50) < 0.3)
    m.compute()
    assert count("curves.auroc_route") == 0


# ------------------------------------------------------ the launch path, faked
class _FakeLibrary:
    """The kernels' C entries as recorders: the sort hands its result back
    in the second buffers (selector 1)."""

    def __init__(self):
        self.calls = []

    def tc_roc_sort_scratch(self, n):
        return 1000

    def tc_roc_integrate_scratch(self, n):
        return 48 * ((n + TILE - 1) // TILE)

    def tc_roc_keys(self, *args):
        self.calls.append(("keys",) + args)
        return 0

    def tc_roc_sort(self, *args):
        self.calls.append(("sort",) + args)
        args[7]._obj.value = 1
        return 0

    def tc_roc_integrate(self, *args):
        self.calls.append(("integrate",) + args)
        return 0


@pytest.fixture
def fake_library(monkeypatch):
    lib = _FakeLibrary()
    reads = []

    def flag_reader(flag):
        reads.append(flag)
        return lambda: lib.flag

    lib.flag = 0
    lib.reads = reads
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(roc_stream, "_flag_reader", flag_reader)
    return lib


@pytest.mark.parametrize("tdtype,code", [
    (torch.float32, 2), (torch.int32, 0), (torch.bool, 1), (torch.uint8, 1),
    (torch.int64, 0), (torch.float64, 0), (torch.float16, 0),
])
def test_the_key_pass_launches_once_a_part_at_its_offset(fake_library, tdtype, code):
    sizes = (5, 4096, 1)
    scores = [torch.rand(n) for n in sizes]
    targets = [(torch.rand(n) < 0.5).to(tdtype) for n in sizes]
    out = roc_stream.binary_auroc_stream(scores, targets)
    assert out is not None and out.shape == () and out.dtype == torch.float32
    keys = [c for c in fake_library.calls if c[0] == "keys"]
    (sort,) = [c for c in fake_library.calls if c[0] == "sort"]
    (integrate,) = [c for c in fake_library.calls if c[0] == "integrate"]
    assert [c[1] for c in keys] == [code] * 3 and [c[4] for c in keys] == list(sizes)
    base_keys, base_labels, flag = keys[0][5], keys[0][6], keys[0][7]
    assert [c[5] - base_keys for c in keys] == [0, 4 * 5, 4 * 4101]
    assert [c[6] - base_labels for c in keys] == [0, 5, 4101]
    assert all(c[7] == flag for c in keys)
    assert keys[0][2] == scores[0].data_ptr()  # float32 scores read where they lie
    n = sum(sizes)
    # the sort of n pairs from the key pass's buffers into the second ones
    assert sort[1] == base_keys and sort[3] == base_labels and sort[5] == n and sort[7] == 1000
    # the integration reads the second buffers (selector 1)
    assert integrate[1] == sort[2] and integrate[2] == sort[4] and integrate[3] == n
    assert integrate[6] == out.data_ptr()
    assert len(fake_library.reads) == (0 if tdtype == torch.bool else 1)


def test_each_c_entry_call_counts_one_launch(fake_library, obs_on):
    scores = [torch.rand(n) for n in (5, 9, 2)]
    targets = [torch.rand(n) < 0.5 for n in (5, 9, 2)]
    roc_stream.binary_auroc_stream(scores, targets)
    steps = [c[0] for c in fake_library.calls]
    assert steps == ["keys", "keys", "keys", "sort", "integrate"]
    assert {s: count("roc_stream.launches", step=s) for s in ("keys", "sort", "integrate")} == {
        "keys": 3, "sort": 1, "integrate": 1}
    assert count("jit.calls") == 0  # the route is no watched entry
    roc_stream.binary_auroc_stream([torch.empty(0)], [torch.empty(0)])
    assert count("roc_stream.launches") == 5  # an empty stream launches nothing


def test_a_set_flag_gives_none(fake_library):
    fake_library.flag = 1
    assert roc_stream.binary_auroc_stream(torch.rand(10), torch.rand(10)) is None
    assert len(fake_library.reads) == 1


def test_half_scores_reach_the_key_pass_as_float32(fake_library, monkeypatch):
    seen = []
    monkeypatch.setattr(_build, "require_cuda", lambda name, *ts: seen.append(ts))
    x = torch.rand(40).to(torch.bfloat16)
    roc_stream.binary_auroc_stream(x[3:], torch.ones(37, dtype=torch.bool))
    (s, t, _), = seen[:1]
    assert s.dtype == torch.float32 and torch.equal(s, x[3:].float())
    assert t.dtype == torch.uint8 and bool((t == 1).all())


def test_an_empty_stream_launches_nothing(fake_library):
    out = roc_stream.binary_auroc_stream([torch.empty(0)], [torch.empty(0)])
    assert float(out) == 0.5 and fake_library.calls == []


def test_the_route_refuses_what_it_cannot_take(fake_library):
    with pytest.raises(ValueError):
        roc_stream.binary_auroc_stream(torch.rand(4, 2), torch.rand(4, 2))
    with pytest.raises(ValueError):
        roc_stream.binary_auroc_stream([torch.rand(4)], [torch.rand(5)])
    with pytest.raises(ValueError):
        roc_stream.binary_auroc_stream([torch.rand(4)], [])


def test_the_sort_buffers_are_carved_apart():
    lib = _FakeLibrary()
    n = 1000
    parts = roc_stream._carve(n, lib, torch.device("cpu"))
    keys, keys_alt, labels, labels_alt, sort_scratch, int_scratch = parts
    assert keys.dtype == keys_alt.dtype == torch.int32 and keys.numel() == keys_alt.numel() == n
    assert labels.numel() == labels_alt.numel() == n and sort_scratch.numel() == 1000
    spans = sorted((p.data_ptr(), p.data_ptr() + p.numel() * p.element_size()) for p in parts)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert all(p.data_ptr() % 256 == spans[0][0] % 256 for p in parts)
    assert curves._takes_stream([keys.float()], [labels]) is False  # the CPU
