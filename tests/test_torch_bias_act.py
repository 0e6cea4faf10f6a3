"""A biased layer's bias add and the activation after it in one pass
(``ops/cuda/bias_act.py``, on the CPU its plain version), the conv ops that
call it (``ops/conv.py``) and the test-mode pairing that hands them the
activation (``layers/sequence.py``).

The registered op ``dorknet::bias_act`` against the bias add then the
activation layer, bit for bit in fp32 and bf16, with y + b exactly -0.0,
NaN, -3, 0, 3 and 6 in some elements. Folded MobileNet-V3-Large (width
0.5) and ResNet-18-depsep test forwards, paired, bit-equal to their layers
run one by one, the pairs counted; a test-mode call that needs a gradient
takes the eager chain, with today's gradients."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dorknet_tpu_torch import config  # noqa: E402
from dorknet_tpu_torch.layers import (ConvLayer, DenseLayer, DepthwiseConvLayer,  # noqa: E402
                                      HardSwish, PointwiseConvLayer, ReLu, ReLu6,
                                      ResidualBlock)
from dorknet_tpu_torch.layers import sequence  # noqa: E402
from dorknet_tpu_torch.layers.base import to_nhwc  # noqa: E402
from dorknet_tpu_torch.models import MobileNetV2, MobileNetV3Large, ResNet18  # noqa: E402
from dorknet_tpu_torch.network import InferenceRunner  # noqa: E402
from dorknet_tpu_torch.ops import conv as conv_ops  # noqa: E402
from dorknet_tpu_torch.ops.cuda.bias_act import bias_act, bias_act_op  # noqa: E402
from dorknet_tpu_torch.utils.fold_bn import fold_batch_norms  # noqa: E402
from dorknet_tpu_torch.utils.seeded import seed_serving_weights  # noqa: E402

ACTS = ["none", "relu", "hswish"]
DTYPES = [torch.float32, torch.bfloat16]
WIDTHS = [1, 3, 16, 120, 960, 1000]
# values of y + b placed in the first rows, -0.0 in channel 0
EDGES = [-0.0, float("nan"), -3.0, 0.0, 3.0, 6.0]
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _inputs(C, dtype, seed, lead=(2, 3, 4)):
    """y and b, b in eighths (so that e - b is exact in bf16 too) with
    b[0] = -0.0; row r of y holds y + b = EDGES[r] in channel r mod C."""
    rng = np.random.RandomState(seed)
    b = np.round(rng.uniform(-4.0, 4.0, C) * 8.0).astype(np.float32) / 8.0
    b[0] = -0.0
    y = (rng.randn(*lead, C) * 3.0).astype(np.float32)
    flat = y.reshape(-1, C)
    for r, e in enumerate(EDGES):
        c = r % C
        flat[r, c] = e if c == 0 or np.isnan(e) else e - b[c]
    return torch.from_numpy(y).to(dtype), torch.from_numpy(b)


def _unfused(y, b, act):
    """The bias add as the conv ops made it (the add in fp32, the result in
    y's dtype), then the activation layer."""
    bshape = (1,) * (y.dim() - 1) + (-1,)
    z = y + b.reshape(bshape) if y.dtype == torch.float32 else \
        (y.float() + b.reshape(bshape)).to(y.dtype)
    if act == "none":
        return z
    return {"relu": ReLu("a"), "hswish": HardSwish("a")}[act].fapply(z)


def _bit_equal(a, b):
    """The same bits, -0.0 included, where not NaN, and NaN in the same
    places (the CPU's vector and scalar loops give NaNs of either sign)."""
    nan = torch.isnan(a)
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(_BITS[a.dtype]), b[~nan].view(_BITS[b.dtype])))


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("act", ACTS)
def test_op_is_the_bias_add_then_the_activation(act, C, dtype):
    y, b = _inputs(C, dtype, seed=C)
    want = _unfused(y, b, act)
    flat = (y.float() + b).reshape(-1, C)
    for r, e in enumerate(EDGES):  # the edges really are in y + b
        got = float(flat[r, r % C])
        assert (np.isnan(got) and np.isnan(e)) or (got == e and np.signbit(got) == np.signbit(e))
    assert _bit_equal(torch.ops.dorknet.bias_act.default(y, b, act), want)
    with torch.no_grad():
        assert _bit_equal(bias_act(y, b, act), want)
        assert _bit_equal(bias_act(y[0, 0], b, act), want[0, 0])  # a dense layer's (N, C)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
def test_op_is_registered_with_a_fake(act, dtype):
    y, b = _inputs(24, dtype, seed=5)
    torch.library.opcheck(torch.ops.dorknet.bias_act.default, (y, b, act),
                          test_utils=("test_schema", "test_faketensor"))
    assert bias_act_op(y[:0], b, act).shape == (0, 3, 4, 24)


def test_bias_act_refuses_what_it_does_not_take():
    y, b = _inputs(8, torch.float32, seed=1)
    with pytest.raises(ValueError, match="act must be one of"):
        bias_act(y, b, "relu6")
    with pytest.raises(ValueError, match="b must be float32 of shape"):
        bias_act(y, b[:7], "relu")
    with pytest.raises(ValueError, match="b must be float32 of shape"):
        bias_act(y, b.double(), "relu")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bias_act(y.double(), b, "relu")
    with pytest.raises(RuntimeError, match="no gradient"):
        bias_act(y.requires_grad_(), b, "relu")


# ---- the conv ops, with and without a gradient ----------------------------------

def _layer(kind):
    """A biased layer of each op, its input, seeded."""
    torch.manual_seed(3)
    if kind == "conv":
        return ConvLayer("l", filter_block_shape=(12, 5, 3, 3)), (2, 7, 7, 5)
    if kind == "depthwise":
        return DepthwiseConvLayer("l", filter_block_shape=(12, 3, 3)), (2, 7, 7, 12)
    if kind == "pointwise":
        return PointwiseConvLayer("l", filter_block_shape=(12, 5), stride=2), (2, 7, 7, 5)
    return DenseLayer("l", incoming_chans=5, output_dim=12), (3, 5)


KINDS = ["conv", "depthwise", "pointwise", "dense"]
BIASED = (ConvLayer, DepthwiseConvLayer, PointwiseConvLayer, DenseLayer)


def _seeded(layer, shape):
    with torch.no_grad():
        layer.bias.copy_(torch.linspace(-3.0, 3.0, layer.bias.numel()))
    return torch.from_numpy(np.random.RandomState(4).randn(*shape).astype(np.float32) * 2.0)


def _eager(layer, x, act, g):
    """The layer, then the activation layer, under autograd: the output and
    the gradients of x, the weights and the bias."""
    xt = x.clone().requires_grad_()
    out = layer.fapply(xt)
    if act != "none":
        out = {"relu": ReLu("a"), "hswish": HardSwish("a")}[act].fapply(out)
    return out, torch.autograd.grad(out, (xt, layer.weights, layer.bias), g)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("kind", KINDS)
def test_a_call_that_needs_a_gradient_takes_the_eager_chain(kind, act, monkeypatch):
    """fapply(x, act=...) with a gradient needed never calls bias_act and
    gives the eager chain's output and gradients bit for bit; without one
    it calls bias_act once, with the same output."""
    layer, shape = _layer(kind)
    x = _seeded(layer, shape)
    g = torch.from_numpy(np.random.RandomState(5).randn(
        *layer.fapply(x).shape).astype(np.float32))
    want, want_grads = _eager(layer, x, act, g)
    calls = []
    monkeypatch.setattr(conv_ops, "bias_act", lambda *a: calls.append(a) or bias_act(*a))
    xt = x.clone().requires_grad_()
    out = layer.fapply(xt, False, act=act)
    grads = torch.autograd.grad(out, (xt, layer.weights, layer.bias), g)
    assert calls == []
    assert torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads, strict=True))
    with torch.no_grad():
        assert torch.equal(layer.fapply(x, False, act=act), want)
    assert len(calls) == 1 and calls[0][2] == act
    calls.clear()
    # grad mode on, nothing to differentiate (torch.matmul's CPU route, and
    # so its rounding, follows the weights' requires_grad: a new reference)
    layer.requires_grad_(False)
    added = layer.fapply(x)  # act=None: the add alone
    assert calls == []
    assert torch.equal(layer.fapply(x, False, act=act), _unfused(added, torch.zeros(12), act))
    assert len(calls) == 1


# ---- whole folded networks ----------------------------------------------------------

NETS = {
    "mnv3l": (lambda: MobileNetV3Large("mnv3l", num_classes=10, width_mult=0.5), 32),
    "resnet18dw": (lambda: ResNet18("dogs", num_classes=10), 33),
}
# the biased layers of each folded test forward, by the act they run with
PAIRS = {"mnv3l": {"none": 16, "relu": 11, "hswish": 21},
         "resnet18dw": {"none": 25, "relu": 10, "hswish": 0}}


def _structure(layers):
    """The folded layer lists' biased layers by the activation after them,
    read from the structure (residual blocks' lists included)."""
    out = dict.fromkeys(ACTS, 0)
    layers = list(layers)
    for a, nxt in zip(layers, layers[1:] + [None]):
        if isinstance(a, ResidualBlock):
            for k, n in _structure(a.layer_list).items():
                out[k] += n
        elif type(a) in BIASED and a.with_bias:
            out[{ReLu: "relu", HardSwish: "hswish"}.get(type(nxt), "none")] += 1
    return out


def _reset_counts():
    sequence.run_layers.fused_bias = dict.fromkeys(ACTS, 0)
    sequence.run_layers.unfused_bias = 0


def _served(kind):
    make, side = NETS[kind]
    np.random.seed(0)
    net = make()
    seed_serving_weights(net, seed=0, calib_hw=(side, side))
    X = np.random.RandomState(1).randn(3, 3, side, side).astype(np.float32)
    return InferenceRunner(net, batch_size=3, device="cpu", fold_bn=True), X


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", list(NETS))
def test_folded_forward_equals_the_layers_one_by_one(kind, dtype, monkeypatch):
    """Paired against every layer's own fapply: the probs bit-equal, in fp32
    and in bf16 flow; every biased layer counted under the act it ran with,
    as the folded model's structure has them."""
    runner, X = _served(kind)
    config.set_compute_dtype(dtype)
    try:
        _reset_counts()
        paired = runner.predict_probs(X)
        counts = dict(sequence.run_layers.fused_bias), sequence.run_layers.unfused_bias
        monkeypatch.setattr(sequence, "BIASED", ())
        _reset_counts()
        alone = runner.predict_probs(X)
        counts_alone = dict(sequence.run_layers.fused_bias)
    finally:
        config.set_compute_dtype(torch.float32)
    assert counts == (PAIRS[kind], 0)
    assert counts_alone == dict.fromkeys(ACTS, 0)
    assert _structure(runner.network.layers) == PAIRS[kind]
    np.testing.assert_array_equal(paired, alone)


def test_relu6_runs_after_the_bias_pass():
    """A folded MobileNet-V2 (width 0.5): every conv takes the bias pass
    with act "none" and its ReLU6 runs after it, counted unfused."""
    np.random.seed(0)
    net = MobileNetV2("mnv2", num_classes=10, width_mult=0.5)
    seed_serving_weights(net, seed=0, calib_hw=(32, 32))
    X = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    runner = InferenceRunner(net, batch_size=2, device="cpu", fold_bn=True)
    _reset_counts()
    p = runner.predict_probs(X)
    assert sequence.run_layers.fused_bias == {"none": 53, "relu": 0, "hswish": 0}
    relu6 = sum(1 for a, b in zip(runner.network.modules(), list(runner.network.modules())[1:])
                if type(a) in BIASED and type(b) is ReLu6)
    assert sequence.run_layers.unfused_bias == relu6 == 35
    assert np.isfinite(p).all()


def test_a_prefix_ending_at_a_conv_returns_its_output_before_the_activation():
    """The test-mode feature tap at a folded conv followed by a ReLU
    returns the conv's biased output, not the ReLU's."""
    runner, X = _served("resnet18dw")
    net = runner.network
    names = [l.layer_name for l in net.layers]
    assert names[:2] == ["conv0", "conv0_relu"]
    x = to_nhwc(torch.from_numpy(X))
    with torch.no_grad():
        _reset_counts()
        feats = net._run_prefix(x, 0)
        assert sequence.run_layers.fused_bias == {"none": 1, "relu": 0, "hswish": 0}
        after = net._run_prefix(x, 1)
        assert sequence.run_layers.fused_bias == {"none": 1, "relu": 1, "hswish": 0}
    assert bool((feats < 0).any())
    assert torch.equal(after, torch.relu(feats))


def test_chip_smoke_table_is_the_served_v3_large():
    """chip_smoke.py's V3L_BIAS: the bias passes of MobileNet-V3-Large's
    BN-folded test forward at 224 px, by output shape and act, recorded
    from one image on the CPU: 48, none 16, relu 11, hswish 21."""
    import chip_smoke

    np.random.seed(0)
    net = MobileNetV3Large("mnv3l", num_classes=1000)
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 224, 224, 3).astype(np.float32))
    with torch.no_grad():
        net._train_forward(x)  # sets every batch norm
    folded = fold_batch_norms(net)
    seen = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(conv_ops, "bias_act", lambda y, b, act: seen.append(
            (tuple(y.shape[1:]), act)) or bias_act(y, b, act))
        with torch.no_grad():
            folded._run_layers(x)
    got = {}
    for key in seen:
        got[key] = got.get(key, 0) + 1
    assert got == {(shape, act): n for shape, act, n in chip_smoke.V3L_BIAS}
    assert len(seen) == 48
    assert chip_smoke.V3L.bias_want == PAIRS["mnv3l"]
