"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM5 (the "NVIDIA H100 80GB HBM3"): 80 GB of HBM3 at 3.35 TB/s,
at the full 700 W power limit (NVIDIA H100 Tensor Core GPU data sheet). A
card set below 700 W (``nvidia-smi --query-gpu=power.limit``) is measured
against the same peak; the run prints the limit beside its numbers.
"""

from typing import Optional

HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(device_name: str) -> Optional[float]:
    """The card's peak memory bandwidth, or None for a card not listed."""
    return HBM_BYTES_PER_S.get(device_name)
