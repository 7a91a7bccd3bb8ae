"""A CTR model's outputs over a held-out day of click logs.

One logit a row. Labels are Bernoulli at ``click_rate``; a positive's
logit is N(``logit_offset`` + ``positive_shift``, 1), a negative's
N(``logit_offset``, 1), so the AUC is Phi(positive_shift / sqrt(2)), and
the offset puts the mean predicted probability at the click rate (a
calibrated model). ``probs`` is the logit's sigmoid (what the model
serves) and ``weights`` are unit weights, as tensors. Made on
``device`` from ``seed`` with one generator, in a few large calls.
"""

import torch


def make(seed: int, rows: int, device: torch.device, params: dict) -> dict:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    labels = torch.rand(rows, generator=g, device=device) < params["click_rate"]
    labels = labels.to(torch.float32)
    logits = torch.randn(rows, generator=g, device=device)
    logits.add_(labels, alpha=params["positive_shift"]).add_(params["logit_offset"])
    return {
        "logits": logits,
        "labels": labels,
        "probs": torch.sigmoid(logits),
        "weights": torch.ones(rows, device=device),
    }
