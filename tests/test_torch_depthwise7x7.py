"""The 7x7 depthwise route on the CPU (``ops/cuda/depthwise7x7.py``): the
weight gradient's plain version, which the CUDA kernel
``csrc/depthwise7x7_dw.cu`` is held to on the card, and the autograd
Function around it. The JAX package has no kernel here (XLA takes every
depthwise shape but 3x3), so both are held to PyTorch's own convolution:

- the plain dw against ``torch.autograd.grad`` of ``F.conv2d(groups=C,
  padding=3)`` in fp64, at images smaller than, as large as and larger than
  the filter;
- ``gradcheck`` of ``Depthwise7x7Fn`` in fp64, and its forward and dx bit-equal
  to autograd's through ``F.conv2d``;
- the dispatch in ``ops/conv.depthwise_conv2d``: only stride 1, padding 3, a
  (C,7,7) filter with C a multiple of 4 and a gradient take the Function;
  without a gradient the output is ``F.conv2d``'s, bit for bit;
- one ConvNeXt-T step runs the weight gradient once for each of its 18
  depthwise layers;
- what the wrapper refuses.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from dorknet_tpu_torch.ops import conv  # noqa: E402
from dorknet_tpu_torch.ops.cuda import depthwise7x7 as dw7  # noqa: E402


def _nchw_conv(x, w, stride=1, padding=3):
    """F.conv2d of an NHWC x with a (C,k,k) depthwise filter, NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.unsqueeze(1), stride=stride, padding=padding,
                 groups=w.shape[0])
    return y.permute(0, 2, 3, 1)


def _inputs(shape, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    N, H, W, C = shape
    x = torch.randn(shape, generator=g).to(dtype)
    w = (torch.randn((C, 7, 7), generator=g) / 7).to(dtype)
    gy = torch.randn(shape, generator=g).to(dtype)
    return x, w, gy


@pytest.mark.parametrize("shape", [
    (1, 3, 3, 4), (3, 5, 5, 8), (1, 7, 7, 96), (3, 3, 7, 4), (1, 9, 9, 8), (3, 13, 9, 4),
    (1, 13, 13, 96), (3, 7, 13, 8), (1, 1, 1, 4),
])
def test_plain_dw_matches_autograd_of_conv2d(shape):
    """fp64: the 49 tap sums within 1e-12 of autograd's, relative to the sum
    of the terms' magnitudes (both sum in another order)."""
    x, w, gy = _inputs(shape, seed=sum(shape))
    wr = w.clone().requires_grad_()
    (want,) = torch.autograd.grad(_nchw_conv(x, wr), (wr,), gy)
    got = dw7.depthwise7x7_dw_plain(x, gy)
    mag = dw7.depthwise7x7_dw_plain(x.abs(), gy.abs())
    assert got.dtype == torch.float64 and got.shape == (shape[3], 7, 7)
    assert float(((got - want).abs() / mag.clamp_min(1e-300)).max()) < 1e-12


def test_plain_dw_sums_fp32_and_bf16_in_fp32():
    x, _, gy = _inputs((2, 9, 9, 8), torch.float32)
    want = dw7.depthwise7x7_dw_plain(x.double(), gy.double())
    for dtype in (torch.float32, torch.bfloat16):
        a, b = x.to(dtype), gy.to(dtype)
        got = dw7.depthwise7x7_dw(a, b)
        assert got.dtype == torch.float32
        ref = dw7.depthwise7x7_dw_plain(a.double(), b.double())
        torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw7.depthwise7x7_dw(x, gy).double(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 3, 3, 4), (2, 5, 4, 4), (1, 8, 6, 4)])
def test_function_gradcheck(shape):
    x, w, _ = _inputs(shape, seed=3)
    assert torch.autograd.gradcheck(dw7.Depthwise7x7Fn.apply,
                                    (x.requires_grad_(), w.requires_grad_()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_forward_and_dx_equal_autograd_of_conv2d(dtype):
    """The Function's forward and dx are the values autograd gives through
    ``F.conv2d`` on the same views, bit for bit; dw is the plain version's."""
    x, w, gy = _inputs((2, 11, 9, 8), dtype, seed=4)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    ya = _nchw_conv(xa, wa).contiguous()
    dxa, _ = torch.autograd.grad(ya, (xa, wa), gy)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    yb = dw7.Depthwise7x7Fn.apply(xb, wb)
    dxb, dwb = torch.autograd.grad(yb, (xb, wb), gy)
    assert torch.equal(ya, yb) and torch.equal(dxa, dxb)
    assert torch.equal(dwb, dw7.depthwise7x7_dw_plain(x, gy).to(dtype))


def test_dw_in_fp32_under_bf16_activations():
    """bf16 activations: the forward and dx in bf16 as autograd gives them,
    dw summed in fp32 and returned in the filter's fp32."""
    x, w, gy = _inputs((2, 7, 7, 8), torch.float32, seed=5)
    xb = x.bfloat16().requires_grad_()
    wb = w.clone().requires_grad_()
    y = dw7.Depthwise7x7Fn.apply(xb, wb)
    dx, dw = torch.autograd.grad(y, (xb, wb), gy.bfloat16())
    assert y.dtype == dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert torch.equal(y, _nchw_conv(xb.detach(), w.bfloat16()).contiguous())
    assert torch.equal(dw, dw7.depthwise7x7_dw_plain(xb.detach(), gy.bfloat16()))


# (k, stride, padding, C): the route each takes with a gradient
ROUTES = [
    ((7, 1, 3, 8), "Depthwise7x7FnBackward"),
    ((7, 1, 3, 96), "Depthwise7x7FnBackward"),
    ((7, 1, 3, 4), "Depthwise7x7FnBackward"),
    ((5, 1, 2, 8), None),
    ((7, 2, 3, 8), None),
    ((7, 1, 2, 8), None),
    ((7, 1, 3, 6), None),
    ((3, 1, 1, 8), "Depthwise3x3FnBackward"),
    ((3, 2, 1, 8), "Depthwise3x3FnBackward"),
    ((3, 1, 1, 6), "Depthwise3x3FnBackward"),
]


@pytest.mark.parametrize("case,route", ROUTES, ids=["k{}s{}p{}c{}".format(*c) for c, _ in ROUTES])
def test_dispatch_by_shape(case, route):
    """With a gradient, only a 7x7 / stride 1 / padding 3 filter with C a
    multiple of 4 takes ``Depthwise7x7Fn``; 3x3 keeps its kernels and the
    rest ``F.conv2d``. Without a gradient every non-3x3 shape gives
    ``F.conv2d``'s output bit for bit, and so does the 7x7 route with one."""
    k, stride, padding, C = case
    g = torch.Generator().manual_seed(C + k)
    x = torch.randn((2, 9, 9, C), generator=g).requires_grad_()
    w = (torch.randn((C, k, k), generator=g) / k).requires_grad_()
    y = conv.depthwise_conv2d(x, w, None, stride=stride, padding=padding)
    name = type(y.grad_fn).__name__
    if route is None:
        assert name not in ("Depthwise7x7FnBackward", "Depthwise3x3FnBackward")
    else:
        assert name == route
    with torch.no_grad():
        y0 = conv.depthwise_conv2d(x, w, None, stride=stride, padding=padding)
    assert y0.grad_fn is None
    if k != 3:
        want = _nchw_conv(x.detach(), w.detach(), stride, padding)
        assert torch.equal(y0, want) and torch.equal(y.detach(), want)


def test_convnext_t_step_runs_the_weight_gradient_once_a_depthwise_layer(monkeypatch):
    """One training step of ConvNeXt-T (published depths and widths, 32 px,
    batch 2) calls the 7x7 weight gradient once for each of its 18
    depthwise layers, each with the layer's shape."""
    from dorknet_tpu_torch.models import ConvNeXt
    from dorknet_tpu_torch.network import Trainer
    from dorknet_tpu_torch.optimisers import AdamW

    seen = []
    real = dw7.depthwise7x7_dw

    def counted(x, g):
        seen.append(tuple(x.shape))
        return real(x, g)

    monkeypatch.setattr(dw7, "depthwise7x7_dw", counted)
    np.random.seed(0)
    net = ConvNeXt("convnext_t", num_classes=10)
    trainer = Trainer(net, AdamW(net, 1e-3), device="cpu")
    rng = np.random.RandomState(1)
    X = rng.randn(2, 3, 32, 32).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[[3, 7]]
    loss, _ = trainer.step(X, y)
    assert np.isfinite(float(loss))
    want = [(2, 8, 8, 96)] * 3 + [(2, 4, 4, 192)] * 3 + [(2, 2, 2, 384)] * 9 + [(2, 1, 1, 768)] * 3
    assert sorted(seen) == sorted(want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.randn(1, 5, 5, 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        dw7.depthwise7x7_dw(torch.randn(1, 5, 5, 6), torch.randn(1, 5, 5, 6))
    with pytest.raises(ValueError, match="one shape"):
        dw7.depthwise7x7_dw(x, torch.randn(1, 5, 4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        dw7.depthwise7x7_dw(x.transpose(1, 2), x)
    with pytest.raises(ValueError, match="float64"):
        dw7.depthwise7x7_dw(x, x.double())
    with pytest.raises(ValueError, match="unsupported device"):
        dw7.launch_dw(x, x)


def test_no_kernel_launch_on_the_cpu():
    before = (dw7.depthwise7x7_dw.launches, dict(dw7.depthwise7x7_dw.launches_by_route))
    x, w, gy = _inputs((1, 7, 7, 4), torch.float32)
    y = conv.depthwise_conv2d(x.requires_grad_(), w.requires_grad_(), None, 1, 3)
    torch.autograd.grad(y, (x, w), gy)
    assert (dw7.depthwise7x7_dw.launches, dw7.depthwise7x7_dw.launches_by_route) == before
