"""The check that decides ``correct`` fails what it must: the control (the
reference computed in bfloat16, in the program's place) and the faults
that a cell can have, each planted under the timed path, at a size that
a CPU test holds."""

import pytest
import torch

from evalbench.core import harness
from evalbench.tests.conftest import small_run
from torcheval_tpu_torch.metrics import MetricCollection

CELLS = ["criteo1tb_ctr_eval.whole", "imagenet1k_val_eval.b256", "imagenet1k_val_eval.whole"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(cell):
    run = small_run(cell)
    assert run.correct and run.failed == 0 and run.compared >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    run = small_run(cell, program_factory=harness.ControlProgram)
    assert not run.correct
    assert run.failed == run.compared


def _unchanged(monkeypatch):
    # a step that returns its state unchanged
    monkeypatch.setattr(MetricCollection, "update", lambda self, *a, **k: self)


def _half_batch(monkeypatch):
    # half of each batch left out: the values are taken over the rest
    update = MetricCollection.update

    def half(self, *args):
        return update(self, *[a[: max(1, a.shape[0] // 2)] for a in args])

    monkeypatch.setattr(MetricCollection, "update", half)


def _altered(monkeypatch):
    # one answer altered where it is produced
    compute = MetricCollection.compute

    def altered(self):
        out = dict(compute(self))
        key = next(iter(out))
        v = out[key].clone()
        flat = v.view(-1)
        flat[0] = flat[0] + 1 if not v.is_floating_point() else flat[0] * (1 + 1e-3)
        out[key] = v
        return out

    monkeypatch.setattr(MetricCollection, "compute", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    run = small_run(cell)
    assert not run.correct


def test_an_altered_count_fails_the_exact_comparison():
    want = torch.zeros(3, 3, dtype=torch.int64)
    got = want.clone()
    got[1, 2] = 1
    assert harness.gap("exact", got, want) == 1.0
    assert harness.gap("rel", torch.tensor([float("nan")]), torch.tensor([1.0])) == float("inf")
    assert harness.gap("rel", torch.empty(0), torch.tensor([1.0])) == float("inf")
