"""The generators: the same seed gives the same inputs; the sizes, class
counts and click rate are as the configurations state."""

import pytest
import torch

from evalbench.core.spec import Spec

SPEC = Spec()
CPU = torch.device("cpu")
BIG_SEED = 2**31 + 123  # larger than 32 signed bits hold


def _make(config, seed, rows):
    cfg = SPEC.config(config)
    return SPEC.module("generators", cfg["generator"]).make(seed, rows, CPU, cfg["generator_params"])


@pytest.mark.parametrize("config,rows", [("criteo1tb_ctr_eval", 50_000), ("imagenet1k_val_eval", 3_000)])
def test_same_seed_same_inputs(config, rows):
    a, b, c = _make(config, BIG_SEED, rows), _make(config, BIG_SEED, rows), _make(config, BIG_SEED + 1, rows)
    assert a.keys() == b.keys() == c.keys()
    for k in a:
        assert a[k].shape[0] == rows
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["labels"], c["labels"])


def test_criteo_click_rate_and_columns():
    rows = 400_000
    x = _make("criteo1tb_ctr_eval", 17, rows)
    rate = SPEC.config("criteo1tb_ctr_eval")["generator_params"]["click_rate"]
    sd = (rate * (1 - rate) / rows) ** 0.5
    assert abs(float(x["labels"].mean()) - rate) < 5 * sd
    assert set(x["labels"].unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(x["probs"], torch.sigmoid(x["logits"]))
    assert torch.equal(x["weights"], torch.ones(rows))
    assert all(v.dtype == torch.float32 for v in x.values())
    # a calibrated model: the mean predicted probability is the click rate
    assert abs(float(x["probs"].mean()) / float(x["labels"].mean()) - 1) < 0.03


def test_imagenet_classes_balanced_and_accuracy_near_stated():
    rows = 5_000
    x = _make("imagenet1k_val_eval", 9, rows)
    assert x["scores"].shape == (rows, 1000) and x["scores"].dtype == torch.float32
    counts = torch.bincount(x["labels"], minlength=1000)
    assert torch.all(counts == rows // 1000)
    assert torch.allclose(x["scores"].sum(1), torch.ones(rows), atol=1e-5)
    top1 = (x["scores"].argmax(1) == x["labels"]).float().mean().item()
    assert 0.72 < top1 < 0.80  # the configuration assumes about 76%


def test_imagenet_rows_must_split_over_classes():
    with pytest.raises(ValueError):
        _make("imagenet1k_val_eval", 1, 1500)
