"""Per-id collision counts.

JAX counterpart: ``torcheval_tpu/metrics/functional/ranking/num_collisions.py``.
As there, one sort and two binary searches of each id against the sorted
ids (``count = right - left``) replace the reference's (N, N) equality
matrix: O(N log N) work and O(N) memory.
"""

from __future__ import annotations

import torch

from torcheval_tpu_torch.utils.convert import as_tensor


def _num_collisions_input_check(input: torch.Tensor) -> None:
    if input.ndim != 1:
        raise ValueError(
            f"input should be a one-dimensional tensor, got shape {tuple(input.shape)}."
        )
    if input.is_floating_point() or input.is_complex() or input.dtype == torch.bool:
        raise ValueError(f"input should be an integer tensor, got {input.dtype}.")


def num_collisions(input) -> torch.Tensor:
    """For each id, the number of *other* occurrences of the same id (int32).

    Args:
        input: 1-D integer ids ``(num_samples,)``.
    """
    input = as_tensor(input)
    _num_collisions_input_check(input)
    sorted_ids = torch.sort(input).values
    left = torch.searchsorted(sorted_ids, input, right=False)
    right = torch.searchsorted(sorted_ids, input, right=True)
    return (right - left - 1).to(torch.int32)
