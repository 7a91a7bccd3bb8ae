"""Per-module FLOP analysis for ``nn.Module``.

JAX counterpart: ``torcheval_tpu/tools/flops.py``. That tool traces a flax
model under ``flax.linen.intercept_methods`` and reads XLA's
``cost_analysis()`` for each recorded call. PyTorch has neither, so the
same two steps are built from PyTorch's own parts:

1. every submodule call is recorded by forward pre- and post-hooks (the
   reference torcheval's module stack, ``torcheval/tools/flops.py:313-326``):
   the module, its dotted name from ``named_modules()``, its class name and
   its inputs. A call that raises is not recorded;
2. each recorded call is then counted on its own, under a
   ``TorchDispatchMode`` that looks every aten op up in the mapping below:
   forward is the FLOPs of the call; backward is the FLOPs of the gradient
   that ``.float().mean().backward()`` sends into the module, taken only
   with respect to the module's own parameters that require grad (its
   inputs are detached and require none, as the JAX tool differentiates
   the variables alone).

Everything runs on ``meta`` tensors of the parameters', buffers' and inputs'
shapes and dtypes: no data is read, nothing runs on a device, and the module
is left as it was found (parameters, buffers, ``.grad``, hooks, ``training``).
The same module gives the same numbers on every device. A parent's count
includes its children's, and repeated calls of one submodule add up.

The unit is the JAX package's: a multiply and an add count separately. The
mapping (every other op counts 0: views, copies, ``t``, ``full_like``,
``exp``, ``softmax`` and the rest):

- ``aten.mm``: 2mkn; ``aten.bmm``: 2bmkn; ``aten.addmm``: 2mkn + mn (the
  bias add);
- ``aten.convolution``: 2 x the multiply-adds, plus the output's elements
  when there is a bias. A multiply-add is one output channel's product
  with one input channel (of its group) at one output position and one
  kernel tap that reads the input: as XLA counts, a tap that lands on
  padding counts nothing;
- ``aten.convolution_backward``: 2 x the same multiply-adds for the
  input's gradient and again for the weight's, each where asked for, plus
  the gradient's elements for the bias's;
- ``aten.add``, ``sub``, ``mul``, ``div``, ``relu`` (and their in-place
  forms) and ``threshold_backward`` (relu's gradient): the output's elements;
- ``aten.sum``, ``aten.mean``: the input's elements.

``.float().mean()`` is not run: its gradient, 1 / the output's elements, is
seeded into the module directly, so the loss's own mean and division count
nothing. Against the JAX tool (``tests/tools/test_module_summary.py``
shapes), forward counts are equal at every node. Backward counts are equal
at a leaf with a bias, where the JAX tool counts the weight's gradient plus
the loss's mean (XLA folds the bias's gradient, a constant) and this tool
the weight's gradient plus the bias's sum: both are the output's elements
(``Dense`` 32 -> 16 on a batch of 4: 4096 + 64 = 4160). A layer with no bias
or no parameters is below the JAX tool's count by the output's elements
(here a parameterless ``ReLU`` counts 0). A parent differs by what XLA
fuses, folds and recomputes: on the MLP 32 -> 16 -> 8 -> 2 at batch 4, the
port gives 4224, 1088 and 6600 for the two blocks and the root where the
JAX tool gives 4592, 1272 and 6768. The reference torcheval counts
multiply-adds of products only; ``torch.utils.flop_counter.FlopCounterMode``
counts 2mkn for products and nothing else, which is this tool's product
share where no convolution is padded (it counts the taps on padding too).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import torch
from torch.func import functional_call
from torch.nn.parameter import is_lazy
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

aten = torch.ops.aten


class ModuleFlops(NamedTuple):
    forward: int
    backward: int


class _CallRecord(NamedTuple):
    name: str
    module: torch.nn.Module
    type_name: str
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]


# ------------------------------------------------------------ the mapping
# each rule maps (args, out) to (product FLOPs, other FLOPs)
Rule = Callable[[Sequence[Any], Any], Tuple[int, int]]


def _mm(args, out) -> Tuple[int, int]:
    m, k = args[0].shape
    return 2 * m * k * args[1].shape[1], 0


def _addmm(args, out) -> Tuple[int, int]:
    return _mm(args[1:], out)[0], out.numel()


def _bmm(args, out) -> Tuple[int, int]:
    b, m, k = args[0].shape
    return 2 * b * m * k * args[1].shape[2], 0


def _valid_taps(positions: int, extent: int, k: int, stride: int, pad: int, dilation: int) -> int:
    """The (position, tap) pairs of one spatial dim whose input index
    ``position * stride - pad + tap * dilation`` lies in ``[0, extent)``:
    a tap on padding reads no input and does no work."""
    total = 0
    for tap in range(k):
        offset = tap * dilation - pad
        lo = max(0, -(offset // stride))  # ceil(-offset / stride)
        hi = min(positions - 1, (extent - 1 - offset) // stride)
        total += max(0, hi - lo + 1)
    return total


def _conv_macs(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, stride, padding, dilation,
               transposed: bool) -> int:
    # weight (C_out, C_in / groups, *kernel), or (C_in, C_out / groups,
    # *kernel) when transposed: every valid (position, tap) pair takes
    # w.shape[0] * w.shape[1] multiply-adds. A transposed convolution is the
    # adjoint of one from its output to its input: its positions are the
    # input's
    spatial = w.dim() - 2
    small, large = (x, out) if transposed else (out, x)
    pairs = math.prod(
        _valid_taps(small.shape[-spatial + d], large.shape[-spatial + d], w.shape[2 + d],
                    stride[d], padding[d], dilation[d])
        for d in range(spatial)
    )
    batch = math.prod(x.shape[: x.dim() - spatial - 1])
    return batch * w.shape[0] * w.shape[1] * pairs


def _convolution(args, out) -> Tuple[int, int]:
    x, w, bias, stride, padding, dilation, transposed = args[:7]
    macs = _conv_macs(x, w, out, stride, padding, dilation, transposed)
    return 2 * macs, (out.numel() if bias is not None else 0)


def _convolution_backward(args, out) -> Tuple[int, int]:
    grad, x, w, _, stride, padding, dilation, transposed = args[:8]
    mask = args[10]
    macs = _conv_macs(x, w, grad, stride, padding, dilation, transposed)
    return 2 * macs * (int(mask[0]) + int(mask[1])), (grad.numel() if mask[2] else 0)


def _elementwise(args, out) -> Tuple[int, int]:
    return 0, out.numel()


def _reduction(args, out) -> Tuple[int, int]:
    return 0, args[0].numel()


FLOP_RULES: Dict[Any, Rule] = {
    aten.mm: _mm,
    aten.addmm: _addmm,
    aten.bmm: _bmm,
    aten.convolution: _convolution,
    aten.convolution_backward: _convolution_backward,
    **{op: _elementwise for op in (
        aten.add, aten.add_, aten.sub, aten.sub_, aten.mul, aten.mul_, aten.div, aten.div_,
        aten.relu, aten.relu_, aten.threshold_backward,
    )},
    aten.sum: _reduction,
    aten.mean: _reduction,
}


class FlopCounter(TorchDispatchMode):
    """Counts the FLOPs of the aten ops run under it by ``FLOP_RULES``:
    ``total``, and ``products``, the share of matrix products and
    convolutions."""

    def __init__(self) -> None:
        super().__init__()
        self.total = 0
        self.products = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rule = FLOP_RULES.get(func.overloadpacket)
        if rule is not None:
            products, rest = rule(args, out)
            self.products += products
            self.total += products + rest
        return out


# ------------------------------------------------------------ the records
def _meta(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return torch.empty_like(value, device="meta")
    return value


def _meta_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for the module's parameters (each requiring grad
    as the parameter does) and buffers."""
    state = {
        name: torch.empty_like(p, device="meta").requires_grad_(p.requires_grad)
        for name, p in module.named_parameters()
    }
    state.update((name, _meta(b)) for name, b in module.named_buffers())
    return state


def _check_initialized(module: torch.nn.Module) -> None:
    if any(is_lazy(t) for t in (*module.parameters(), *module.buffers())):
        raise ValueError(
            "the module has uninitialized (lazy) parameters or buffers; run it "
            "once on real inputs before counting its FLOPs"
        )


def _record_calls(module: torch.nn.Module, args, kwargs) -> List[_CallRecord]:
    """Run ``module`` once on ``meta`` stand-ins and record every submodule
    call that returned, in the order the calls returned."""
    _check_initialized(module)
    names = {id(m): name for name, m in module.named_modules()}
    records: List[_CallRecord] = []
    pending: List[Tuple[torch.nn.Module, Tuple[Any, ...], Dict[str, Any]]] = []

    def pre(mod, call_args, call_kwargs):
        pending.append((mod, call_args, call_kwargs))

    def post(mod, call_args, call_kwargs, output):
        # calls of other modules left open had raised inside this one
        while pending[-1][0] is not mod:
            pending.pop()
        _, recorded_args, recorded_kwargs = pending.pop()
        records.append(_CallRecord(names[id(mod)], mod, type(mod).__name__,
                                   recorded_args, recorded_kwargs))

    handles = []
    try:
        for _, mod in module.named_modules():
            handles.append(mod.register_forward_pre_hook(pre, with_kwargs=True))
            handles.append(mod.register_forward_hook(post, with_kwargs=True))
        with torch.no_grad():
            functional_call(module, _meta_state(module), tree_map(_meta, tuple(args)),
                            tree_map(_meta, dict(kwargs)))
    finally:
        for handle in handles:
            handle.remove()
    return records


def _count_call(rec: _CallRecord, backward: bool) -> ModuleFlops:
    """One recorded call counted on its own (its forward ran on ``meta``
    when it was recorded); backward -1 when not asked for, when the output
    is not one tensor, or when the gradient cannot run on ``meta`` (a
    backward that reads data), as the JAX tool's is -1 where XLA refuses
    the gradient."""
    state = _meta_state(rec.module)
    with FlopCounter() as counter, torch.set_grad_enabled(backward):
        out = functional_call(rec.module, state, rec.args, rec.kwargs)
        forward = counter.total
        if not backward or not isinstance(out, torch.Tensor):
            return ModuleFlops(forward, -1)
        params = [t for t in state.values() if t.requires_grad]
        if params and out.requires_grad:
            # the gradient .float().mean().backward() sends into the module
            seed = torch.full_like(out, 1.0 / out.numel())
            try:
                torch.autograd.grad(out, params, seed, allow_unused=True)
            except RuntimeError:
                return ModuleFlops(forward, -1)
    return ModuleFlops(forward, counter.total - forward)


def _flops_of(records: Sequence[_CallRecord], backward: bool) -> Dict[str, ModuleFlops]:
    out: Dict[str, ModuleFlops] = {}
    for rec in records:
        counted = _count_call(rec, backward)
        prev = out.get(rec.name)
        if prev is None:
            out[rec.name] = counted
        else:
            out[rec.name] = ModuleFlops(
                prev.forward + counted.forward,
                prev.backward + counted.backward
                if prev.backward >= 0 and counted.backward >= 0
                else -1,
            )
    return out


def module_flops(
    module: torch.nn.Module, *args, backward: bool = True, **kwargs
) -> Dict[str, ModuleFlops]:
    """Forward and backward FLOPs for every submodule an ``nn.Module``'s
    forward pass calls.

    Args:
        module: the model; it is not changed.
        *args / **kwargs: example inputs (tensors on any device, or
            ``meta`` tensors: only their shapes and dtypes are read).
        backward: also count backward FLOPs (one gradient per call).

    Returns:
        ``{name: ModuleFlops(forward, backward)}`` keyed by the dotted names
        of ``named_modules()``; ``""`` is the root. Backward is -1 when not
        computed. Raises ``ValueError`` for a module with uninitialized
        (lazy) parameters, and ``RuntimeError`` for a forward that cannot
        run on ``meta`` tensors (one that reads its data, as ``.item()``).
    """
    return _flops_of(_record_calls(module, args, kwargs), backward)


def record_module_types(module: torch.nn.Module, *args, **kwargs) -> Dict[str, str]:
    """``{name: class name}`` for every submodule reached by the forward
    pass."""
    return {rec.name: rec.type_name for rec in _record_calls(module, args, kwargs)}
