"""Module summaries for ``nn.Module``.

JAX counterpart: ``torcheval_tpu/tools/module_summary.py``; reference:
``torcheval/tools/module_summary.py:41-503``. Parameter and byte counts walk
the module's own parameters and buffers; FLOPs come from
:mod:`torcheval_tpu_torch.tools.flops`, on ``meta`` tensors. A module's
numbers include its whole subtree; the tree follows ``named_children()``
and names each node by its dotted ``named_modules()`` name.

Where PyTorch differs from flax, this follows the reference torcheval:

- ``get_module_summary(module)`` with no inputs works: a torch module holds
  its parameters before any call, so the counts are there and the FLOPs are
  -1. The JAX tool's "example inputs" ``TypeError`` has no counterpart;
- ``has_uninitialized_param`` is true where a lazy module still holds an
  ``UninitializedParameter`` (or buffer). Those count 0, and FLOPs are not
  computed for a module that holds one (the reference's ``:219-229``).

Buffers count the way the JAX tool counts collections other than
``params``: in ``num_parameters`` and ``size_bytes``, not in the trainable
count. Trainable means ``requires_grad``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.nn.parameter import is_lazy

from torcheval_tpu_torch.tools.flops import ModuleFlops, module_flops

_ATTRIB_TO_COL_HEADER = {
    "module_name": "Name",
    "module_type": "Type",
    "num_parameters": "# Parameters",
    "num_trainable_parameters": "# Trainable Parameters",
    "size_bytes": "Size (bytes)",
    "has_uninitialized_param": "Contains Uninitialized Parameter?",
    "flops_forward": "Forward FLOPs",
    "flops_backward": "Backward FLOPs",
}
_FLOP_ATTRIBS = ("flops_forward", "flops_backward")
_PARAMETER_NUM_UNITS = (" ", "K", "M", "B", "T")
_PARAMETER_FLOPS_UNITS = (" ", "k", "M", "G", "T", "P", "E", "Z", "Y")


class ModuleSummary:
    """Summary record for one module and (recursively) its submodules:
    name, type, parameter and trainable counts, byte size, uninitialized
    flag, forward and backward FLOPs (-1 = not computed), and a dict of
    child summaries."""

    def __init__(self) -> None:
        self._module_name: str = ""
        self._module_type: str = ""
        self._num_parameters: int = 0
        self._num_trainable_parameters: int = 0
        self._size_bytes: int = 0
        self._submodule_summaries: Dict[str, "ModuleSummary"] = {}
        self._has_uninitialized_param: bool = False
        self._flops_forward: int = -1
        self._flops_backward: int = -1

    @property
    def submodule_summaries(self) -> Dict[str, "ModuleSummary"]:
        return self._submodule_summaries

    @property
    def module_name(self) -> str:
        return self._module_name

    @property
    def module_type(self) -> str:
        return self._module_type

    @property
    def num_parameters(self) -> int:
        return self._num_parameters

    @property
    def num_trainable_parameters(self) -> int:
        return self._num_trainable_parameters

    @property
    def size_bytes(self) -> int:
        return self._size_bytes

    @property
    def has_uninitialized_param(self) -> bool:
        """True where the subtree holds a lazy module's
        ``UninitializedParameter`` or ``UninitializedBuffer``."""
        return self._has_uninitialized_param

    @property
    def flops_forward(self) -> int:
        return self._flops_forward

    @property
    def flops_backward(self) -> int:
        return self._flops_backward

    def __repr__(self) -> str:
        return get_summary_table(self)


def get_module_summary(
    module: torch.nn.Module,
    module_args: Tuple[Any, ...] = (),
    module_kwargs: Optional[Dict[str, Any]] = None,
    *,
    compute_flops: Optional[bool] = None,
) -> ModuleSummary:
    """Summarize an ``nn.Module``: parameters, bytes, and (with example
    inputs) forward and backward FLOPs per submodule.

    Args:
        module: the model; it is not changed.
        module_args / module_kwargs: example inputs (tensors on any device,
            or ``meta`` tensors: only shapes and dtypes are read).
        compute_flops: defaults to ``bool(module_args or module_kwargs)``,
            the reference's "FLOPs iff an input is given". FLOPs stay -1 for
            a module with uninitialized (lazy) parameters.
    """
    module_kwargs = module_kwargs or {}
    if compute_flops is None:
        compute_flops = bool(module_args or module_kwargs)
    flops: Dict[str, ModuleFlops] = {}
    lazy = any(is_lazy(t) for t in (*module.parameters(), *module.buffers()))
    if compute_flops and not lazy:
        flops = module_flops(module, *module_args, **module_kwargs)
    return _build(module, "", flops)


def _build(module: torch.nn.Module, name: str, flops: Dict[str, ModuleFlops]) -> ModuleSummary:
    ms = ModuleSummary()
    ms._module_name = name
    ms._module_type = type(module).__name__
    for tensor, trainable in (*((p, p.requires_grad) for p in module.parameters()),
                              *((b, False) for b in module.buffers())):
        if is_lazy(tensor):
            ms._has_uninitialized_param = True
            continue
        n = tensor.numel()
        ms._num_parameters += n
        ms._size_bytes += n * tensor.element_size()
        if trainable:
            ms._num_trainable_parameters += n
    if name in flops:
        ms._flops_forward, ms._flops_backward = flops[name]
    for child_name, child in module.named_children():
        full = f"{name}.{child_name}" if name else child_name
        ms._submodule_summaries[full] = _build(child, full, flops)
    return ms


def prune_module_summary(module_summary: ModuleSummary, *, max_depth: int) -> None:
    """In-place: drop submodule summaries below ``max_depth`` levels
    (reference ``module_summary.py:363-383``)."""
    if max_depth < 1:
        raise ValueError(f"`max_depth` must be an int greater than 0, got {max_depth}.")
    if max_depth == 1:
        module_summary._submodule_summaries.clear()
        return
    for child in module_summary._submodule_summaries.values():
        prune_module_summary(child, max_depth=max_depth - 1)


def _human_readable(num: float, units) -> str:
    if num < 0:
        return str(num)
    idx = 0
    while num >= 1000 and idx < len(units) - 1:
        num /= 1000.0
        idx += 1
    digits = f"{num:.1f}".rstrip("0").rstrip(".")
    return f"{digits} {units[idx]}".rstrip()


def get_summary_table(
    module_summary: ModuleSummary, human_readable_nums: bool = True
) -> str:
    """Fixed-width text table over the summary tree (reference
    ``module_summary.py:296-360``)."""
    has_flops = module_summary.flops_forward >= 0
    attribs = [
        a
        for a in _ATTRIB_TO_COL_HEADER
        if has_flops or a not in _FLOP_ATTRIBS
    ]

    rows = []

    def _format(ms: ModuleSummary, attrib: str) -> str:
        value = getattr(ms, attrib)
        if isinstance(value, bool):
            return "Yes" if value else "No"
        if isinstance(value, int):
            if not human_readable_nums:
                return str(value)
            units = (
                _PARAMETER_FLOPS_UNITS
                if attrib in _FLOP_ATTRIBS
                else _PARAMETER_NUM_UNITS
            )
            return _human_readable(value, units)
        return str(value)

    def _walk(ms: ModuleSummary) -> None:
        rows.append([_format(ms, a) for a in attribs])
        for child in ms.submodule_summaries.values():
            _walk(child)

    _walk(module_summary)
    headers = [_ATTRIB_TO_COL_HEADER[a] for a in attribs]
    widths = [
        max(len(headers[i]), *(len(r[i]) for r in rows)) for i in range(len(headers))
    ]
    lines = [
        " | ".join(h.ljust(w) for h, w in zip(headers, widths)),
        "-+-".join("-" * w for w in widths),
    ]
    for r in rows:
        lines.append(" | ".join(c.ljust(w) for c, w in zip(r, widths)))
    table = "\n".join(lines)
    if has_flops:
        table += (
            "\nRemark for FLOPs calculation: (1) Only the mapped aten ops are "
            "counted, and an op outside the mapping counts 0; multiplies and "
            "adds count separately (an (m,k)x(k,n) product is 2mkn FLOPs), an "
            "elementwise op counts one FLOP an output element and a reduction "
            "one an input element. (2) Backward FLOPs are those of the gradient "
            "of the mean of the module output with respect to the module's own "
            "parameters."
        )
    return table
