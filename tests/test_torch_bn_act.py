"""The activation after a train-mode batch norm, in the batch norm's own
ops (``ops/cuda/bn_train.py``'s ``act``; on the CPU their plain versions),
and the layer lists that hand them the pair (``layers/sequence.py``).

Against the unfused chain, ``bn_apply`` then ``torch.relu`` or
``HardSwish.fapply`` under autograd: the forward bit-equal in fp32 and
bf16; in fp32 the gradients of x, gamma and beta bit-equal too (the same
operations in the same order); in bf16 within the rounding that the
unfused chain adds to the activation's gradient. Inputs where y is
exactly -3, 0 and 3 hold ReLU's 0 at y == 0 and the clip's 0.5 at its
bounds. Whole train steps of ResNet-50 v1.5, MobileNet-V3-Large and
ResNet-18-depsep equal those with every layer run on its own; the fused
pairs counted, and confirmed from each model's layer lists."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark_torch.harness.trace import ELEMENTWISE, kernel_class  # noqa: E402
from dorknet_tpu_torch.layers import (BatchNormLayer, HardSwish, ReLu,  # noqa: E402
                                      ResidualBlock)
from dorknet_tpu_torch.layers import sequence  # noqa: E402
from dorknet_tpu_torch.models import (MobileNetV2, MobileNetV3Large, ResNet18,  # noqa: E402
                                      ResNet50)
from dorknet_tpu_torch.network import InferenceRunner, Trainer  # noqa: E402
from dorknet_tpu_torch.ops import norm  # noqa: E402
from dorknet_tpu_torch.ops.activation import BN_ACTIVATIONS, constant  # noqa: E402
from dorknet_tpu_torch.ops.cuda.bn_stats import batch_norm_stats  # noqa: E402
from dorknet_tpu_torch.ops.cuda.bn_train import (bn_apply, bn_bwd_dx,  # noqa: E402
                                                 bn_bwd_reduce)
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402

EPS = 1e-5
ACTS = ["relu", "hswish"]
DTYPES = [torch.float32, torch.bfloat16]
# 16: both dtypes' 16-byte vectors; 12: fp32's 4 only; 13: neither
WIDTHS = [16, 12, 13]
# the edge channels' beta, with gamma 0: y is exactly beta in every row
EDGES = [-3.0, 0.0, 3.0]


def _inputs(C, dtype, seed, lead=(2, 3, 5)):
    """x, a cotangent of act(y), gamma and beta; the last three channels
    have gamma 0 and beta -3, 0, 3."""
    rng = np.random.RandomState(seed)
    shape = lead + (C,)
    x = torch.from_numpy((rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    gamma = (1.0 + 0.5 * rng.randn(C)).astype(np.float32)
    beta = rng.uniform(-4.0, 4.0, C).astype(np.float32)
    gamma[-3:], beta[-3:] = 0.0, EDGES
    return x, g, torch.from_numpy(gamma), torch.from_numpy(beta)


def _unfused(x, g, gamma, beta, act):
    """act(y) and the gradients of (x, gamma, beta): the batch norm, then
    the activation as a layer applies it, under autograd."""
    xt, gt, bt = (t.clone().requires_grad_() for t in (x, gamma, beta))
    y, _, _ = norm._BNCore.apply(xt, gt, bt, EPS)
    out = {"relu": ReLu("a"), "hswish": HardSwish("a")}[act].fapply(y)
    return out, torch.autograd.grad(out, (xt, gt, bt), g)


def _fused(x, g, gamma, beta, act):
    xt, gt, bt = (t.clone().requires_grad_() for t in (x, gamma, beta))
    out, _, _ = norm._BNCore.apply(xt, gt, bt, EPS, act)
    return out, torch.autograd.grad(out, (xt, gt, bt), g)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("act", ACTS)
def test_fused_forward_is_bit_equal(act, C, dtype):
    x, _, gamma, beta = _inputs(C, dtype, seed=C)
    mean, var = batch_norm_stats(x)
    y, norm2 = bn_apply(x, mean, var, gamma, beta, EPS)
    out, norm_fused = bn_apply(x, mean, var, gamma, beta, EPS, act)
    assert out.dtype == dtype and torch.equal(norm_fused, norm2)
    assert torch.equal(out, BN_ACTIVATIONS[act](y))
    assert torch.equal(out, _unfused(x, x, gamma, beta, act)[0])


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("act", ACTS)
def test_fused_gradients_match_the_unfused_chain(act, C, dtype):
    """fp32: dx, dgamma and dbeta bit-equal. bf16: dx within two bf16 steps
    of the unfused chain's (whose activation gradient is rounded to bf16),
    dgamma and dbeta within 2^-7 of the sums of their terms' magnitudes."""
    x, g, gamma, beta = _inputs(C, dtype, seed=100 + C)
    out, got = _fused(x, g, gamma, beta, act)
    ref_out, want = _unfused(x, g, gamma, beta, act)
    assert torch.equal(out, ref_out)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    if dtype == torch.float32:
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)
        return
    scale = float(want[0].float().abs().max())
    np.testing.assert_allclose(got[0].float().numpy(), want[0].float().numpy(),
                               rtol=2 ** -6, atol=2 ** -7 * scale)
    mag = (g.float().abs() * (1.0 + x.float().abs())).reshape(-1, C).sum(0)
    for a, b in zip(got[1:], want[1:], strict=True):
        assert bool(((a - b).abs() <= 2 ** -7 * mag).all())




def _edge_slope(act, dtype):
    """The activations' derivative at y = -3, 0, 3: ReLU 0 at 0
    (threshold_backward); hard-swish h(y) + y * s * clip'(y + 3), clip' 0.5
    at the bounds, s the constant 1/6 in x's dtype (h(-3), h(0) and h(3)
    round to 0, 0.5 and 1 in both dtypes)."""
    if act == "relu":
        return torch.tensor([0.0, 0.0, 1.0])
    s = float(constant(1.0 / 6.0, dtype))
    return torch.tensor([-3.0 * s * 0.5, 0.5, 1.0 + 3.0 * s * 0.5])


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
def test_derivative_at_the_bounds(act, dtype):
    """Where gamma is 0, y is beta in every row and dbeta is act'(beta)
    times the sum of the cotangent."""
    x, g, gamma, beta = _inputs(16, dtype, seed=7)
    mean, var = batch_norm_stats(x)
    out, saved = bn_apply(x, mean, var, gamma, beta, EPS, act)
    assert torch.equal(out[..., -3:].float(),
                       BN_ACTIVATIONS[act](torch.tensor(EDGES)).expand_as(out[..., -3:]))
    dgamma, dbeta, _ = bn_bwd_reduce(g, x, saved, gamma, beta, act)
    want = _edge_slope(act, dtype) * g.float().reshape(-1, 16)[:, -3:].sum(0)
    np.testing.assert_allclose(dbeta[-3:].numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    _, want_grads = _unfused(x, g, gamma, beta, act)
    if dtype == torch.float32:
        assert torch.equal(dbeta, want_grads[2])


def test_backward_wrappers_check_act():
    x = torch.zeros(4, 8)
    ones = torch.ones(8)
    with pytest.raises(ValueError, match="act must be one of"):
        bn_apply(x, ones, ones, ones, ones, EPS, "relu6")
    with pytest.raises(ValueError, match="needs gamma and beta"):
        bn_bwd_reduce(x, x, torch.zeros(2, 8), ones, None, "relu")
    with pytest.raises(ValueError, match="needs gamma and beta"):
        bn_bwd_dx(x, x, torch.zeros(2, 8), torch.zeros(3, 8), ones, None, "hswish")
    with pytest.raises(ValueError, match="beta must be contiguous float32 of shape"):
        bn_bwd_dx(x, x, torch.zeros(2, 8), torch.zeros(3, 8), ones, ones[:7], "hswish")
    with pytest.raises(ValueError, match="train mode only"):
        layer = BatchNormLayer("bn", incoming_chans=8, input_dimension=2)
        layer._write_running_stats(torch.zeros(8), torch.ones(8), "cpu")
        layer.fapply(x, train=False, act="relu")


def test_new_kernels_are_classed_as_elementwise():
    """Every kernel of csrc/bn_train.cu (the test-mode bias pass among them),
    in every instantiation as the profiler names it, falls in the class
    elementwise_share reads."""
    src = (Path(__file__).resolve().parents[1] / "dorknet_tpu_torch" / "csrc"
           / "bn_train.cu").read_text()
    kernels = re.findall(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(", src)
    assert sorted(kernels) == ["bias_act_kernel", "bn_apply_kernel", "bn_bwd_dx_kernel",
                               "bn_bwd_finish_kernel", "bn_bwd_reduce_kernel"]
    names = ["void (anonymous namespace)::{}<{}, {}, ((anonymous namespace)::Act){}>"
             "(float const*, float const*, float*, long, int, long)".format(k, t, v, a)
             for k in kernels for t, v in (("float", 1), ("float", 4), ("__nv_bfloat16", 1),
                                           ("__nv_bfloat16", 8))
             for a in range(3)]
    for name in names:
        assert kernel_class(name) == ELEMENTWISE, name


# ---- whole networks ---------------------------------------------------------

NETS = {
    "resnet50": (lambda: ResNet50("resnet50", num_classes=10, v1_5=True), 32, 10),
    "mnv3l": (lambda: MobileNetV3Large("mnv3l", num_classes=10), 32, 10),
    "resnet18dw": (lambda: ResNet18("dogs", num_classes=10), 33, 10),
}
# BN -> ReLU and BN -> hard-swish pairs a train-mode forward fuses
PAIRS = {"resnet50": {"relu": 33, "hswish": 0}, "mnv3l": {"relu": 11, "hswish": 20},
         "resnet18dw": {"relu": 10, "hswish": 0}}


def _adjacent_pairs(layers):
    """BN -> ReLu / HardSwish neighbours in a layer list and in every
    residual block's list, counted from the model's structure."""
    out = {"relu": 0, "hswish": 0}
    layers = list(layers)
    for a, b in zip(layers, layers[1:] + [None]):
        if isinstance(a, ResidualBlock):
            for k, n in _adjacent_pairs(a.layer_list).items():
                out[k] += n
        elif type(a) is BatchNormLayer and type(b) in (ReLu, HardSwish):
            out["relu" if type(b) is ReLu else "hswish"] += 1
    return out


def _reset_counts():
    sequence.run_layers.fused = dict.fromkeys(("relu", "hswish"), 0)
    sequence.run_layers.unfused = 0


def _batch(side, classes, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(2, 3, side, side).astype(np.float32)
    return X, np.eye(classes, dtype=np.float32)[[1, 2]]


def _forward_grads(kind, monkeypatch, fuse):
    """loss, probs, every gradient, the running stats and the pair counts
    of a fresh network's training forward."""
    make, side, classes = NETS[kind]
    with monkeypatch.context() as m:
        if not fuse:
            m.setattr(sequence, "FUSED_ACTS", {})
        np.random.seed(0)
        net = make()
        X, y = _batch(side, classes)
        _reset_counts()
        loss, probs = net.forward(X, y)
        counts = dict(sequence.run_layers.fused), sequence.run_layers.unfused
    grads = [g.detach().clone() for g in net._pending_grads.values()]
    return loss, probs, grads, [b.clone() for b in net.buffers()], counts


@pytest.mark.parametrize("kind", list(NETS))
def test_training_forward_equals_the_layers_one_by_one(kind, monkeypatch):
    """Fused against every layer's own fapply: the same loss, probs and
    running stats bit for bit, the gradients within 1e-6 (they read
    bit-equal on the CPU); the fused pairs counted as the model has them,
    and none left unfused."""
    loss, probs, grads, stats, counts = _forward_grads(kind, monkeypatch, True)
    loss1, probs1, grads1, stats1, counts1 = _forward_grads(kind, monkeypatch, False)
    np.random.seed(0)
    assert counts == (PAIRS[kind], 0)
    assert _adjacent_pairs(NETS[kind][0]().layers) == PAIRS[kind]
    assert counts1 == (dict.fromkeys(PAIRS[kind], 0), sum(PAIRS[kind].values()))
    assert torch.equal(loss, loss1) and torch.equal(probs, probs1)
    assert len(stats) == len(stats1) > 0
    assert all(torch.equal(a, b) for a, b in zip(stats, stats1, strict=True))
    assert len(grads) == len(grads1)
    for a, b in zip(grads, grads1, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9)


def _steps(kind, remat, n=2):
    make, side, classes = NETS[kind]
    np.random.seed(0)
    net = make()
    trainer = Trainer(net, SGDMomentum(net, 0.002, 0.9), device="cpu", remat=remat)
    _reset_counts()
    losses = [float(trainer.step(*_batch(side, classes, seed=s))[0]) for s in range(n)]
    counts = dict(sequence.run_layers.fused)
    return losses, [p.detach().clone() for p in net.parameters()], \
        [b.clone() for b in net.buffers()], counts


def test_block_remat_fuses_the_same_pairs():
    """Trainer(remat="blocks"): two steps bit-equal to remat=False, the
    recomputed blocks fusing their pairs again with the running stats
    frozen: 2 top-level pairs once and 8 block pairs twice a step."""
    losses, params, stats, counts = _steps("resnet18dw", False)
    losses1, params1, stats1, counts1 = _steps("resnet18dw", "blocks")
    assert losses == losses1
    assert all(torch.equal(a, b) for a, b in zip(params, params1, strict=True))
    assert all(torch.equal(a, b) for a, b in zip(stats, stats1, strict=True))
    assert counts == {"relu": 2 * 10, "hswish": 0}
    assert counts1 == {"relu": 2 * (2 + 8 * 2), "hswish": 0}


def test_eval_serving_and_relu6_fuse_nothing():
    """A test-mode forward and a served batch run no pair fused; the
    MobileNet-V2 step leaves each of its BN -> ReLU6 pairs unfused."""
    np.random.seed(0)
    net = MobileNetV2("mnv2", num_classes=10, width_mult=0.5)
    X, y = _batch(32, 10)
    _reset_counts()
    net.forward(X, y)
    relu6 = sum(1 for a, b in zip(net.modules(), list(net.modules())[1:])
                if type(a) is BatchNormLayer and type(b).__name__ == "ReLu6")
    assert sequence.run_layers.fused == {"relu": 0, "hswish": 0}
    assert sequence.run_layers.unfused == relu6 == 35
    make, side, classes = NETS["mnv3l"]
    np.random.seed(0)
    net = make()
    net.forward(*_batch(side, classes))  # sets the running stats
    _reset_counts()
    net.forward(X, test_mode=True)
    InferenceRunner(net, batch_size=2, device="cpu").predict_probs(X)
    assert sequence.run_layers.fused == {"relu": 0, "hswish": 0}
    assert sequence.run_layers.unfused == 0


def test_tap_on_a_batch_norm_fuses_nothing_across_it():
    """A train-mode feature tap at a batch norm returns the batch norm's
    output, not its activation's."""
    np.random.seed(0)
    net = ResNet18("dogs", num_classes=10)
    X, y = _batch(33, 10)
    net.forward(X, y)
    _reset_counts()
    _, feats = net.forward(X, terminal_layer_name="conv0_bn")
    assert sequence.run_layers.fused == {"relu": 0, "hswish": 0}
    assert bool((feats < 0).any())
    _, after = net.forward(X, terminal_layer_name="conv0_relu")
    assert sequence.run_layers.fused == {"relu": 1, "hswish": 0}
    assert torch.equal(after, torch.relu(feats))
