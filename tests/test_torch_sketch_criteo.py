"""The sketch AUROC of the Criteo evaluation, as the benchmark's
``criteo1tb_ctr_eval_approx`` configuration builds it, on the CPU at a
small size: ``BinaryAUROC(approx=True)`` inside a ``MetricCollection``
beside NE, over the Criteo generator's rows.

* Its value equals the plain bucketed AUROC (``evalbench/reference/
  _bucketed_auroc.py``: the same bucket map and tie-at-one-half AUROC,
  written out from the definition, in float64) to float32 rounding, for
  one whole batch and for batches that cross the 65,536-row fold cadence
  (the last batch's rows fold inside ``compute()``).
* It lies within ``auroc_error_bound`` of the exact AUROC.
* With obs on, each fold of staged rows runs in one
  ``metric.fold/BinaryAUROC`` span (``kind=score``) inside the update (or
  the compute, for leftovers), and ``sketch.folds{kind=score}`` counts
  the update's folds; with obs off, no span is recorded.
"""

import math

import pytest
import torch

from evalbench.core import harness
from evalbench.core.spec import Spec
from evalbench.reference import BinaryAUROC as exact_reference
from evalbench.reference._bucketed_auroc import bucketed_auroc
from torcheval_tpu_torch import obs
from torcheval_tpu_torch.sketch import SKETCH_FOLD_ROWS, auroc_error_bound
from torcheval_tpu_torch.sketch.cache import folded_sketch_parts

CELL = "criteo1tb_ctr_eval_approx.whole"
CPU = torch.device("cpu")
SEED = 2**31 + 19
# The program integrates the bucket counts in float32 (int32 cumulative
# counts widened to float32, then a trapezoid summed over 2^16 + 1 points);
# the reference in float64. Each float32 rounding is at most 2^-24 (6e-8)
# relative; a tree sum over 2^16 terms has 16 levels of them, and counts
# past 2^24 round once more: about 1e-6. The gaps read 1e-9 to 2e-7.
FLOAT32_TOLERANCE = 1e-6
# (rows, batch): one whole batch at the two ends of the sizes tested, and
# batches of 40,000 (each second one crosses the cadence; the last
# 8,576 rows are left for the compute's fold)
SHAPES = [(1 << 16, 1 << 16), (1 << 20, 1 << 20), (1 << 20, 40_000)]


@pytest.fixture(autouse=True)
def _clean():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _program(rows, batch, seed=SEED):
    """The configuration's collections and one pass's batches, on the CPU."""
    cell = harness.Cell(Spec(), CELL, rows=rows, batch_rows=batch)
    inputs = cell.inputs(seed, CPU)
    return cell, harness.Program(cell, CPU), inputs, cell.batches(inputs)


def _auroc_member(program):
    for _, col in program.collections:
        if "auroc" in col.metrics:
            return col.metrics["auroc"]
    raise AssertionError("no auroc member")


def test_the_configuration_builds_the_sketch_auroc():
    _, program, _, _ = _program(1 << 16, 1 << 16)
    m = _auroc_member(program)
    assert m._sketch_bits == 16
    assert tuple(m.sketch_tp.shape) == tuple(m.sketch_fp.shape) == (1 << 16,)
    assert m.sketch_tp.dtype == torch.int32


@pytest.mark.parametrize("rows,batch", SHAPES)
def test_the_sketch_auroc_equals_the_bucketed_reference(rows, batch):
    _, program, inputs, batches = _program(rows, batch)
    values = harness.run_pass(program, batches, CPU)
    want = float(bucketed_auroc(inputs["logits"], inputs["labels"]))
    got = float(values["auroc"])
    assert abs(got - want) / want <= FLOAT32_TOLERANCE, (got, want)


@pytest.mark.parametrize("rows,batch", SHAPES)
def test_the_sketch_auroc_lies_within_its_error_bound(rows, batch):
    _, program, inputs, batches = _program(rows, batch)
    got = float(harness.run_pass(program, batches, CPU)["auroc"])
    # the resident sketch with any staged leftovers: the bound is over every row
    tp, fp, _ = folded_sketch_parts(_auroc_member(program))
    assert int(tp.sum() + fp.sum()) == rows
    bound = auroc_error_bound(tp, fp)
    exact = float(exact_reference.reference([inputs["logits"], inputs["labels"]], {}, torch.float64))
    assert 0 < bound < 2e-3
    assert abs(got - exact) <= bound


def _fold_spans():
    return [e for e in obs.timeline_events()
            if e["kind"] == "span" and e["name"].endswith("metric.fold/BinaryAUROC")]


def _folds_counted():
    counters = obs.snapshot()["counters"]
    return counters.get("sketch.folds{kind=score}", 0.0), counters.get("sketch.folded_rows{kind=score}", 0.0)


@pytest.mark.parametrize("rows,batch", SHAPES)
def test_each_fold_runs_in_one_span_and_is_counted(rows, batch):
    _, program, _, batches = _program(rows, batch)
    harness.run_pass(program, batches, CPU)  # the warm pass, obs off
    obs.enable()
    harness.run_pass(program, batches, CPU)
    obs.disable()
    staged, update_folds = 0, 0
    for b in batches:
        staged += b["logits"].shape[0]
        if staged >= SKETCH_FOLD_ROWS:
            update_folds, staged = update_folds + 1, 0
    spans = _fold_spans()
    assert len(spans) == update_folds + (staged > 0)
    parents = [e["labels"]["parent"] for e in spans]
    assert parents[:update_folds] == ["collection.update/metric.update/BinaryAUROC"] * update_folds
    assert parents[update_folds:] == ["collection.compute/metric.compute/BinaryAUROC"] * (staged > 0)
    assert {e["labels"]["kind"] for e in spans} == {"score"}
    assert all(e["dur"] > 0 for e in spans)
    # the counters count the update's folds and their rows, not the
    # compute's fold of leftovers (which leaves the state as it was)
    assert _folds_counted() == (float(update_folds), float(rows - staged))
    if batch == rows:
        assert update_folds == 1 and len(spans) == 1


def test_with_obs_off_no_span_is_recorded():
    _, program, _, batches = _program(1 << 20, 40_000)
    harness.run_pass(program, batches, CPU)
    harness.run_pass(program, batches, CPU)
    assert _fold_spans() == []
    assert obs.snapshot()["spans"] == {} and _folds_counted() == (0.0, 0.0)


def test_the_compute_fold_leaves_the_state_as_it_was():
    _, program, _, batches = _program(1 << 20, 40_000)
    harness.run_pass(program, batches, CPU)
    m = _auroc_member(program)
    staged = sum(a.shape[0] for a in m.inputs)
    before = (m.sketch_tp.clone(), m.sketch_fp.clone())
    first, second = float(m.compute()), float(m.compute())
    assert staged > 0 and first == second and not math.isnan(first)
    assert torch.equal(m.sketch_tp, before[0]) and torch.equal(m.sketch_fp, before[1])
    assert sum(a.shape[0] for a in m.inputs) == staged


def test_a_multiclass_fold_runs_in_a_span_of_its_own_kind():
    import torcheval_tpu_torch.metrics as T

    g = torch.Generator().manual_seed(3)
    m = T.MulticlassAUROC(num_classes=4, approx=True, device="cpu")
    obs.enable()
    for rows in (SKETCH_FOLD_ROWS, 100):  # one fold in the update, one in the compute
        m.update(torch.rand(rows, 4, generator=g), torch.randint(0, 4, (rows,), generator=g))
    m.compute()
    spans = [e for e in obs.timeline_events()
             if e["kind"] == "span" and e["name"].endswith("metric.fold/MulticlassAUROC")]
    assert [e["labels"]["parent"] for e in spans] == [
        "metric.update/MulticlassAUROC", "metric.compute/MulticlassAUROC"]
    assert {e["labels"]["kind"] for e in spans} == {"mc_score"}
    assert obs.snapshot()["counters"]["sketch.folds{kind=mc_score}"] == 1.0


@pytest.mark.parametrize(
    "cls,kwargs,width,kind",
    [
        ("BinaryPrecisionRecallCurve", {}, None, "score"),
        ("MulticlassPrecisionRecallCurve", {"num_classes": 4}, 4, "mc_score"),
    ],
)
def test_a_curve_compute_folds_its_leftovers_in_the_span(cls, kwargs, width, kind):
    import torcheval_tpu_torch.metrics as T

    g = torch.Generator().manual_seed(5)
    m = getattr(T, cls)(approx=True, device="cpu", **kwargs)
    shape = (100,) if width is None else (100, width)
    target = torch.randint(0, 2 if width is None else width, (100,), generator=g)
    obs.enable()
    m.update(torch.rand(shape, generator=g), target)  # staged, below the cadence
    first = m.compute()
    second = m.compute()
    spans = [e for e in obs.timeline_events()
             if e["kind"] == "span" and e["name"].endswith(f"metric.fold/{cls}")]
    assert len(spans) == 2 and {e["labels"]["kind"] for e in spans} == {kind}
    assert all(e["labels"]["parent"].endswith(f"metric.compute/{cls}") for e in spans)
    # the compute's fold leaves the state as it was
    assert sum(a.shape[0] for a in m.inputs) == 100
    assert int(m.sketch_tp.sum() + m.sketch_fp.sum()) == 0
    for a, b in zip(first, second):
        if isinstance(a, list):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            assert torch.equal(a, b)
