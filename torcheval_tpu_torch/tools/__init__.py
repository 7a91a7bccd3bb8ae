"""Module summaries and per-module FLOPs for ``nn.Module``.

JAX counterpart: ``torcheval_tpu/tools/__init__.py``; the same five names.
"""

from torcheval_tpu_torch.tools.flops import module_flops
from torcheval_tpu_torch.tools.module_summary import (
    ModuleSummary,
    get_module_summary,
    get_summary_table,
    prune_module_summary,
)

__all__ = [
    "ModuleSummary",
    "get_module_summary",
    "get_summary_table",
    "module_flops",
    "prune_module_summary",
]
