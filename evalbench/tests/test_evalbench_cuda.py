"""One cell of each configuration through ``evalbench/run.py`` on the
card, briefly. Marked ``cuda``: skips without a card. Run on the card
with ``python -m pytest evalbench/tests -m cuda``."""

import json
import subprocess
import sys

import pytest
import torch

from evalbench.core.spec import ROOT

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cell", ["imagenet1k_val_eval.whole", "criteo1tb_ctr_eval.whole"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_on_the_card_is_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "evalbench/run.py", "--workload", cell, "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
