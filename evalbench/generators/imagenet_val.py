"""A classifier's softmax scores over a class-balanced validation set.

``rows / num_classes`` rows of each class, in an order shuffled by the
seed. Every logit is N(0, 1) except the true class's, which is
N(``true_logit_mean``, ``true_logit_std``); the scores are the softmax of
the logits in float32. Made on ``device`` from ``seed`` with one
generator, in a few large calls.
"""

import torch


def make(seed: int, rows: int, device: torch.device, params: dict) -> dict:
    c = int(params["num_classes"])
    if rows % c:
        raise ValueError(f"{rows} rows do not split evenly over {c} classes")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    order = torch.randperm(rows, generator=g, device=device)
    labels = torch.arange(c, device=device).repeat_interleave(rows // c)[order]
    logits = torch.randn(rows, c, generator=g, device=device)
    true = torch.randn(rows, generator=g, device=device)
    true.mul_(params["true_logit_std"]).add_(params["true_logit_mean"])
    logits[torch.arange(rows, device=device), labels] = true
    return {"scores": torch.softmax(logits, dim=1), "labels": labels}
