"""``torcheval_tpu_torch.tools`` against the JAX package's ``tools`` on the
same layer shapes and the same weights.

The flax models are those of ``tests/tools/test_module_summary.py``; their
torch twins get the flax weights through ``utils/jax_state.py``, so equal
outputs prove the shapes and the carry. The JAX tool's numbers are computed
here from the JAX tool, not copied. Forward FLOPs are equal at every node,
backward FLOPs at the leaves; at a parent the port counts what its mapping
sees and XLA what it fuses and folds, and the gap is stated below (and in
``torcheval_tpu_torch/tools/flops.py``)."""

import importlib.util
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from torcheval_tpu import tools as jax_tools
from torcheval_tpu_torch import tools as port_tools
from torcheval_tpu_torch.tools.flops import FlopCounter, ModuleFlops, record_module_types
from torcheval_tpu_torch.utils.jax_state import (
    flax_conv_kernel,
    flax_dense_kernel,
    load_flax_params,
)

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "_jax_tool_models", ROOT / "tests" / "tools" / "test_module_summary.py"
)
_jax_models = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_jax_models)
FlaxMLP, FlaxConvNet = _jax_models.MLP, _jax_models.ConvNet

RTOL = 1e-5


def _assert_outputs_close(got, want):
    """Within rtol 1e-5, and an absolute 1e-5 of the largest |output|: an
    output near 0 is a float32 sum that cancels, whose last bits depend on
    the order of the sum (XLA's and PyTorch's differ)."""
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


# ------------------------------------------------------------ the twins
class TorchBlock(torch.nn.Module):
    def __init__(self, d_in: int, feat: int):
        super().__init__()
        self.linear = torch.nn.Linear(d_in, feat)

    def forward(self, x):
        return torch.relu(self.linear(x))


class TorchMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.block0 = TorchBlock(32, 16)
        self.block1 = TorchBlock(16, 8)
        self.head = torch.nn.Linear(8, 2)

    def forward(self, x):
        return self.head(self.block1(self.block0(x)))


class TorchConvNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 8, 3)

    def forward(self, x):
        return self.conv(x)


class FlaxClassifier(fnn.Module):
    """The layer types of ``chip_smoke.py``'s conv classifier at a small
    size: strided convolutions, relu, flatten (channels first, as torch's
    ``Flatten`` of NCHW), a dense head."""

    @fnn.compact
    def __call__(self, x):
        x = fnn.relu(fnn.Conv(8, (7, 7), strides=2, padding=3)(x))
        x = fnn.relu(fnn.Conv(16, (3, 3), strides=2, padding=1)(x))
        x = jnp.transpose(x, (0, 3, 1, 2)).reshape(x.shape[0], -1)
        return fnn.Dense(10)(x)


def torch_classifier():
    return torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 7, stride=2, padding=3),
        torch.nn.ReLU(),
        torch.nn.Conv2d(8, 16, 3, stride=2, padding=1),
        torch.nn.ReLU(),
        torch.nn.Flatten(),
        torch.nn.Linear(16 * 8 * 8, 10),
    )


class FlaxTwice(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        inner = fnn.Dense(4, name="inner")
        return inner(inner(x))


class TorchTwice(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.inner = torch.nn.Linear(4, 4)

    def forward(self, x):
        return self.inner(self.inner(x))


# flax path -> torch name, node by node; and the layers whose weights carry
MLP_NODES = {
    (): "",
    ("Block_0",): "block0",
    ("Block_0", "Dense_0"): "block0.linear",
    ("Block_1",): "block1",
    ("Block_1", "Dense_0"): "block1.linear",
    ("Dense_0",): "head",
}
MLP_PAIRS = [(t, f) for f, t in MLP_NODES.items() if f and f[-1] == "Dense_0"]
MLP_TYPES = {"MLP": "TorchMLP", "Block": "TorchBlock", "Dense": "Linear"}
CLASSIFIER_NODES = {(): "", ("Conv_0",): "0", ("Conv_1",): "2", ("Dense_0",): "5"}
MLP_LEAVES = [p for p in MLP_NODES if p and p[-1] == "Dense_0"]
MLP_PARENTS = [p for p in MLP_NODES if p not in MLP_LEAVES]

# The port's backward FLOPs at the MLP's parents (batch 4), from its
# mapping: each Linear's weight gradient (2mkn), its bias sum (the
# gradient's elements), relu's gradient (its elements), and each input
# gradient below the top layer (2mkn):
#   block0: 4096 + 64 + 64 = 4224; block1: 1024 + 32 + 32 = 1088;
#   root: 4224 + 1088 + 1024 (block1's input gradient) + 128 + 8 + 128 = 6600.
# The JAX tool gives 4592, 1272 and 6768: XLA fuses relu's gradient into
# selects it recomputes, counts the loss's mean, and folds the constant
# bias gradients.
PORT_PARENT_BACKWARD = {(): 6600, ("Block_0",): 4224, ("Block_1",): 1088}
JAX_PARENT_BACKWARD = {(): 6768, ("Block_0",): 4592, ("Block_1",): 1272}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _mlp_pair(seed=0):
    x = np.random.default_rng(seed).standard_normal((4, 32)).astype(np.float32)
    params = _np_tree(FlaxMLP().init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    model = TorchMLP()
    load_flax_params(model, params, MLP_PAIRS)
    return x, params, model


def _classifier_pair(seed=1):
    x = np.random.default_rng(seed).standard_normal((2, 32, 32, 3)).astype(np.float32)
    params = _np_tree(FlaxClassifier().init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    model = torch_classifier()
    load_flax_params(model, params, [(t, f) for f, t in CLASSIFIER_NODES.items() if f])
    return x, params, model


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _jax_flops(model, x):
    return jax_tools.module_flops(model, jnp.asarray(x))


def _summary_nodes(ms, out=None):
    out = {} if out is None else out
    out[ms.module_name] = ms
    for child in ms.submodule_summaries.values():
        _summary_nodes(child, out)
    return out


# ------------------------------------------------------------ weights
def test_mlp_outputs_equal_with_the_weights_carried():
    x, params, model = _mlp_pair()
    want = np.asarray(FlaxMLP().apply({"params": params}, jnp.asarray(x)))
    got = model(torch.from_numpy(x)).detach().numpy()
    _assert_outputs_close(got, want)


def test_conv_outputs_equal_with_the_weights_carried():
    x = np.random.default_rng(2).standard_normal((1, 8, 8, 3)).astype(np.float32)
    params = _np_tree(FlaxConvNet().init(jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    model = TorchConvNet()
    load_flax_params(model, params, [("conv", ("conv",))])
    want = np.asarray(FlaxConvNet().apply({"params": params}, jnp.asarray(x)))
    got = model(_nchw(x)).detach().numpy().transpose(0, 2, 3, 1)
    _assert_outputs_close(got, want)


def test_classifier_outputs_equal_with_the_weights_carried():
    x, params, model = _classifier_pair()
    want = np.asarray(FlaxClassifier().apply({"params": params}, jnp.asarray(x)))
    _assert_outputs_close(model(_nchw(x)).detach().numpy(), want)


def test_kernel_layouts():
    dense = np.arange(6, dtype=np.float32).reshape(2, 3)  # (in, out)
    assert torch.equal(flax_dense_kernel(dense), torch.from_numpy(dense.T.copy()))
    conv = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)  # HWIO
    got = flax_conv_kernel(conv)
    assert got.shape == (5, 4, 2, 3)
    assert got[4, 3, 1, 2] == conv[1, 2, 3, 4]


def test_load_flax_params_refuses_a_mismatch():
    _, params, _ = _mlp_pair()
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(TorchMLP(), params, [("block0.linear", ("Block_1", "Dense_0"))])
    with pytest.raises(ValueError, match="bias"):
        load_flax_params(torch.nn.Sequential(torch.nn.Linear(32, 16, bias=False)), params,
                         [("0", ("Block_0", "Dense_0"))])


# ------------------------------------------------------------ counts and tree
def test_param_counts_equal_the_jax_tool():
    x, _, model = _mlp_pair()
    want = jax_tools.get_module_summary(FlaxMLP(), (jnp.asarray(x),), compute_flops=False)
    ms = port_tools.get_module_summary(model)
    assert (ms.num_parameters, ms.num_trainable_parameters, ms.size_bytes) == (682, 682, 682 * 4)
    assert (ms.num_parameters, ms.num_trainable_parameters, ms.size_bytes) == (
        want.num_parameters, want.num_trainable_parameters, want.size_bytes)
    assert not ms.has_uninitialized_param


def test_tree_maps_node_by_node():
    x, _, model = _mlp_pair()
    want = _summary_nodes(jax_tools.get_module_summary(FlaxMLP(), (jnp.asarray(x),)))
    got = _summary_nodes(port_tools.get_module_summary(model, (torch.from_numpy(x),)))
    assert set(got) == set(MLP_NODES.values())
    for path, name in MLP_NODES.items():
        j, p = want[".".join(path)], got[name]
        assert MLP_TYPES[j.module_type] == p.module_type, name
        assert (p.num_parameters, p.num_trainable_parameters, p.size_bytes) == (
            j.num_parameters, j.num_trainable_parameters, j.size_bytes), name
        assert {MLP_NODES[tuple(c.split("."))] for c in j.submodule_summaries} == set(
            p.submodule_summaries), name


def test_forward_flops_equal_the_jax_tool_at_every_node():
    x, _, model = _mlp_pair()
    want = _jax_flops(FlaxMLP(), x)
    got = port_tools.module_flops(model, torch.from_numpy(x))
    assert set(got) == set(MLP_NODES.values())
    for path, name in MLP_NODES.items():
        assert got[name].forward == want[path].forward, name
    # the JAX tool's numbers on this tree
    assert [want[p].forward for p in MLP_NODES] == [5448, 4224, 4160, 1088, 1056, 136]


def test_backward_flops_equal_at_the_leaves_and_the_parents_gap_is_stated():
    x, _, model = _mlp_pair()
    want = _jax_flops(FlaxMLP(), x)
    got = port_tools.module_flops(model, torch.from_numpy(x))
    for path in MLP_LEAVES:
        assert got[MLP_NODES[path]].backward == want[path].backward, path
    assert [want[p].backward for p in MLP_LEAVES] == [4160, 1056, 136]
    for path in MLP_PARENTS:
        assert got[MLP_NODES[path]].backward == PORT_PARENT_BACKWARD[path], path
        assert want[path].backward == JAX_PARENT_BACKWARD[path], path


def test_summary_flops_are_module_flops():
    x, _, model = _mlp_pair()
    flops = port_tools.module_flops(model, torch.from_numpy(x))
    nodes = _summary_nodes(port_tools.get_module_summary(model, (torch.from_numpy(x),)))
    for name, ms in nodes.items():
        assert ModuleFlops(ms.flops_forward, ms.flops_backward) == flops[name], name


def test_convnet_flops_equal_the_jax_tool():
    x = np.ones((1, 8, 8, 3), np.float32)
    want = _jax_flops(FlaxConvNet(), x)
    got = port_tools.module_flops(TorchConvNet(), _nchw(x))
    # Conv2d(3, 8, 3) on 1x3x8x8: 7776 multiply-adds, twice, plus 288 bias adds
    assert got["conv"].forward == want[("conv",)].forward == 2 * 7776 + 288
    assert got[""].forward == want[()].forward == 2 * 7776 + 288
    assert got["conv"].backward == want[("conv",)].backward


def test_classifier_flops_equal_the_jax_tool():
    """Strided, padded convolutions, ReLU and Flatten modules: the root and
    the layers with weights equal the JAX tool, ReLU counts its output's
    elements and Flatten none."""
    x, _, model = _classifier_pair()
    want = _jax_flops(FlaxClassifier(), x)
    got = port_tools.module_flops(model, _nchw(x))
    for path, name in CLASSIFIER_NODES.items():
        assert got[name].forward == want[path].forward, name
    for path in CLASSIFIER_NODES:
        if path:
            assert got[CLASSIFIER_NODES[path]].backward == want[path].backward, path
    conv0, conv1 = 2 * 8 * 16 * 16, 2 * 16 * 8 * 8  # output elements
    assert (got["1"], got["3"], got["4"]) == (
        ModuleFlops(conv0, 0), ModuleFlops(conv1, 0), ModuleFlops(0, 0))
    assert got[""].forward == sum(got[str(i)].forward for i in range(6))
    # by hand from the mapping: 2 x the multiply-adds that read the input,
    # the bias adds, relu; then the head's product and bias
    taps0, taps1 = _taps_by_loop(16, 32, 7, 2, 3) ** 2, _taps_by_loop(8, 16, 3, 2, 1) ** 2
    by_hand = (2 * 2 * 8 * 3 * taps0 + conv0 + conv0) + (2 * 2 * 16 * 8 * taps1 + conv1 + conv1) + (
        2 * 2 * 1024 * 10 + 2 * 10)
    assert got[""].forward == by_hand


def _taps_by_loop(positions, extent, k, stride, pad, dilation=1):
    return sum(1 for o in range(positions) for t in range(k)
               if 0 <= o * stride - pad + t * dilation < extent)


def test_valid_taps_equal_a_loop():
    from torcheval_tpu_torch.tools.flops import _valid_taps

    for positions in (1, 5, 16):
        for extent in (1, 7, 32):
            for k in (1, 3, 7):
                for stride in (1, 2, 3):
                    for pad in (0, 1, 3, 9):
                        for dilation in (1, 2):
                            assert _valid_taps(positions, extent, k, stride, pad, dilation) == (
                                _taps_by_loop(positions, extent, k, stride, pad, dilation))


@pytest.mark.parametrize("stride,padding,dilation", [(1, 0, 1), (2, 3, 1), (3, 1, 2)])
def test_a_transposed_convolution_counts_as_its_adjoint(stride, padding, dilation):
    conv = torch.nn.Conv2d(6, 4, 5, stride=stride, padding=padding, dilation=dilation, bias=False)
    x = torch.ones(2, 6, 19, 19)
    y = conv(x)
    extra = 19 - ((y.shape[-1] - 1) * stride - 2 * padding + dilation * 4 + 1)
    adjoint = torch.nn.ConvTranspose2d(4, 6, 5, stride=stride, padding=padding, dilation=dilation,
                                       output_padding=extra, bias=False)
    assert adjoint(y).shape == x.shape
    flops = port_tools.module_flops(conv, x)[""]
    assert port_tools.module_flops(adjoint, y)[""] == ModuleFlops(flops.forward, flops.forward)
    assert flops.forward == flops.backward


def test_repeated_calls_add_up():
    x = np.ones((2, 4), np.float32)
    want = jax_tools.module_flops(FlaxTwice(), jnp.asarray(x))
    got = port_tools.module_flops(TorchTwice(), torch.from_numpy(x))
    assert got["inner"].forward == want[("inner",)].forward == 2 * (2 * 2 * 4 * 4 + 8)
    assert got["inner"].backward == want[("inner",)].backward
    assert got[""].forward == want[()].forward


def test_prune():
    x, _, model = _mlp_pair()
    ms = port_tools.get_module_summary(model, (torch.from_numpy(x),))
    port_tools.prune_module_summary(ms, max_depth=2)
    assert set(ms.submodule_summaries) == {"block0", "block1", "head"}
    for child in ms.submodule_summaries.values():
        assert len(child.submodule_summaries) == 0
    with pytest.raises(ValueError):
        port_tools.prune_module_summary(ms, max_depth=0)


def test_summary_table():
    x, _, model = _mlp_pair()
    ms = port_tools.get_module_summary(model, (torch.from_numpy(x),))
    table = port_tools.get_summary_table(ms)
    want = jax_tools.get_summary_table(
        jax_tools.get_module_summary(FlaxMLP(), (jnp.asarray(x),)))
    headers = [[h.strip() for h in t.splitlines()[0].split(" | ")] for t in (table, want)]
    assert headers[0] == headers[1]
    assert "block0.linear" in table
    assert "outside the mapping counts 0" in table
    raw = port_tools.get_summary_table(ms, human_readable_nums=False)
    assert "682" in raw and "5448" in raw
    no_flops = port_tools.get_summary_table(port_tools.get_module_summary(model))
    assert "Forward FLOPs" not in no_flops and "Remark" not in no_flops


def test_human_readable_matches_the_jax_tool():
    from torcheval_tpu.tools import module_summary as jax_ms
    from torcheval_tpu_torch.tools import module_summary as port_ms

    for num in (-1, 0, 7, 999, 1000, 1500, 682_000, 5_448_000_000, 10**20):
        for units in (port_ms._PARAMETER_NUM_UNITS, port_ms._PARAMETER_FLOPS_UNITS):
            assert port_ms._human_readable(num, units) == jax_ms._human_readable(num, units)


@pytest.mark.parametrize("which", ["mlp", "conv", "strided_conv"])
def test_product_share_equals_flop_counter_mode(which):
    """Where no convolution is padded: ``FlopCounterMode`` also counts the
    taps on padding, which XLA and this tool do not (the classifier test)."""
    if which == "mlp":
        x, _, model = _mlp_pair()
        x = torch.from_numpy(x)
    elif which == "conv":
        model, x = TorchConvNet(), torch.ones(1, 3, 8, 8)
    else:
        model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 7, stride=2), torch.nn.ReLU(),
                                    torch.nn.Flatten(), torch.nn.Linear(8 * 13 * 13, 10))
        x = torch.randn(2, 3, 32, 32)
    with FlopCounter() as ours:
        out = model(x)
        forward = ours.products
        out.float().mean().backward()
    with FlopCounterMode(display=False) as theirs:
        out = model(x)
        forward_theirs = theirs.get_total_flops()
        out.float().mean().backward()
    assert forward == forward_theirs
    assert ours.products == theirs.get_total_flops()
    if which == "mlp":
        assert forward == 5248


def test_counts_do_not_depend_on_the_inputs_device():
    x, _, model = _classifier_pair()
    x = _nchw(x)
    assert port_tools.module_flops(model, x) == port_tools.module_flops(model, x.to("meta"))


def test_record_module_types():
    x, _, model = _mlp_pair()
    types = record_module_types(model, torch.from_numpy(x))
    assert types == {"": "TorchMLP", "block0": "TorchBlock", "block0.linear": "Linear",
                     "block1": "TorchBlock", "block1.linear": "Linear", "head": "Linear"}


def test_kwargs_reach_the_module():
    class Scaled(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.linear = torch.nn.Linear(4, 4)

        def forward(self, x, *, scale):
            return self.linear(x) * scale

    got = port_tools.module_flops(Scaled(), torch.ones(2, 4), scale=torch.ones(2, 4))
    assert got["linear"].forward == 2 * 2 * 4 * 4 + 8
    assert got[""].forward == got["linear"].forward + 8


def test_a_lazy_module_reports_uninitialized_and_stays_lazy():
    model = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.LazyLinear(3))
    ms = port_tools.get_module_summary(model, (torch.ones(2, 4),))
    assert ms.has_uninitialized_param
    assert ms.submodule_summaries["1"].has_uninitialized_param
    assert not ms.submodule_summaries["0"].has_uninitialized_param
    assert ms.num_parameters == 4 * 8 + 8
    assert ms.flops_forward == -1 and ms.flops_backward == -1
    assert torch.nn.parameter.is_lazy(model[1].weight)
    with pytest.raises(ValueError, match="uninitialized"):
        port_tools.module_flops(model, torch.ones(2, 4))


def test_no_inputs_gives_counts_and_flops_of_minus_one():
    _, _, model = _mlp_pair()
    ms = port_tools.get_module_summary(model)
    assert ms.num_parameters == 682
    assert (ms.flops_forward, ms.flops_backward) == (-1, -1)
    assert all(c.flops_forward == -1 for c in _summary_nodes(ms).values())
    ms = port_tools.get_module_summary(model, (torch.ones(4, 32),), compute_flops=False)
    assert ms.flops_forward == -1


def test_buffers_count_but_do_not_train():
    model = torch.nn.Sequential(torch.nn.Linear(4, 6), torch.nn.BatchNorm1d(6))
    model[0].bias.requires_grad_(False)
    ms = port_tools.get_module_summary(model)
    bn = ms.submodule_summaries["1"]
    # weight and bias (12), running mean and variance (12), num_batches_tracked (1, int64)
    assert (bn.num_parameters, bn.num_trainable_parameters, bn.size_bytes) == (25, 12, 24 * 4 + 8)
    assert ms.num_trainable_parameters == 4 * 6 + 12
    assert ms.num_parameters == 4 * 6 + 6 + 25


@pytest.mark.parametrize("training", [True, False])
def test_the_module_is_left_as_found(training):
    model = torch.nn.Sequential(
        torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4), torch.nn.ReLU(inplace=True),
        torch.nn.Flatten(), torch.nn.Dropout(0.5), torch.nn.Linear(4 * 6 * 6, 5))
    model.train(training)
    x = torch.randn(2, 3, 8, 8)
    model(x).sum().backward()  # every parameter holds a .grad, the buffers have moved
    model[5].weight.grad = None  # and one holds none
    before = {k: v.clone() for k, v in model.state_dict().items()}
    grads = {n: None if p.grad is None else p.grad.clone() for n, p in model.named_parameters()}
    x_before = x.clone()
    ms = port_tools.get_module_summary(model, (x,))
    assert ms.flops_forward > 0 and ms.flops_backward > 0
    after = model.state_dict()
    assert before.keys() == after.keys()
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    for n, p in model.named_parameters():
        assert (p.grad is None) == (grads[n] is None), n
        if p.grad is not None:
            assert torch.equal(p.grad, grads[n]), n
    assert torch.equal(x, x_before)
    for m in model.modules():
        assert m.training is training
        assert not m._forward_hooks and not m._forward_pre_hooks
        assert not m._forward_hooks_with_kwargs and not m._forward_pre_hooks_with_kwargs


class _ScaledByData(torch.autograd.Function):
    """Identity forward; a backward that reads a tensor's value."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(scale)
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        (scale,) = ctx.saved_tensors
        return grad * float(scale.sum()), None


def test_a_gradient_the_meta_device_cannot_run_is_minus_one():
    class Reads(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.linear = torch.nn.Linear(4, 4)

        def forward(self, x):
            y = self.linear(x)
            return _ScaledByData.apply(y, y.detach())

    got = port_tools.module_flops(Reads(), torch.ones(2, 4))
    assert got == {"linear": ModuleFlops(2 * 2 * 4 * 4 + 8, 2 * 2 * 4 * 4 + 8),
                   "": ModuleFlops(2 * 2 * 4 * 4 + 8, -1)}


def test_a_forward_the_meta_device_cannot_run_raises():
    class Reads(torch.nn.Module):
        def forward(self, x):
            return x * float(x.sum())

    with pytest.raises(RuntimeError):
        port_tools.module_flops(Reads(), torch.ones(2, 4))
