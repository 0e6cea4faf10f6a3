"""The port's depthwise 3x3 backward (on CPU: the plain dx and dw versions,
directly and through ``Depthwise3x3Fn``) against ``jax.vjp`` of the JAX
package's Pallas kernel in interpret mode, finite differences in float64,
and the wrappers' argument checks.

Tolerances, as the JAX package's own backward test
(tests/test_pallas_kernels.py): dx rtol/atol 1e-4; dw rtol 1e-4, atol 1e-3
(dw sums N*Ho*Wo products per tap, in another order on each side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.ops.pallas.depthwise as pdw  # noqa: E402

import dorknet_tpu_torch.ops.cuda.depthwise as tdw  # noqa: E402
from dorknet_tpu_torch.ops.cuda.depthwise import (  # noqa: E402
    Depthwise3x3Fn, depthwise3x3, depthwise3x3_dw, depthwise3x3_dx, dw_bands)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pdw, "_INTERPRET", True)


def _case(stride, H, W, C, seed):
    rng = np.random.RandomState(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = rng.randn(2, H, W, C).astype(np.float32)
    w = rng.randn(C, 3, 3).astype(np.float32)
    g = rng.randn(2, Ho, Wo, C).astype(np.float32)
    return x, w, g


def _jax_vjp(x, w, g, stride):
    _, pullback = jax.vjp(lambda a, b: pdw.depthwise3x3(a, b, stride),
                          jnp.asarray(x), jnp.asarray(w))
    dx, dw = pullback(jnp.asarray(g))
    return np.asarray(dx), np.asarray(dw)


@pytest.mark.parametrize("C", [8, 24])
@pytest.mark.parametrize("H", [8, 9, 14])
@pytest.mark.parametrize("stride", [1, 2])
def test_plain_backward_matches_pallas_vjp(stride, H, C):
    """Even H at stride 2 (8->4, 14->7): the last row and column of x get
    only the di = 2 / dj = 2 taps."""
    x, w, g = _case(stride, H, H, C, seed=stride * 1000 + H * 10 + C)
    want_dx, want_dw = _jax_vjp(x, w, g, stride)
    dx = depthwise3x3_dx(torch.from_numpy(g), torch.from_numpy(w), stride, H, H)
    dw = depthwise3x3_dw(torch.from_numpy(x), torch.from_numpy(g), stride)
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dw.numpy(), want_dw, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("stride,H,W", [(1, 9, 8), (2, 9, 8), (2, 8, 11)])
def test_autograd_function_matches_pallas_vjp(stride, H, W):
    """The same gradients through autograd (Depthwise3x3Fn), non-square."""
    x, w, g = _case(stride, H, W, 8, seed=H * 10 + W)
    want_dx, want_dw = _jax_vjp(x, w, g, stride)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = depthwise3x3(xt, wt, stride)
    assert y.grad_fn is not None and "Depthwise3x3Fn" in type(y.grad_fn).__name__
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dw.numpy(), want_dw, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("stride", [1, 2])
def test_autograd_function_finite_differences(stride):
    """torch.autograd.gradcheck in float64 on a 5x5x3 case (the plain
    versions sum in float64 for float64 inputs)."""
    rng = np.random.RandomState(stride)
    x = torch.from_numpy(rng.randn(2, 5, 5, 3)).requires_grad_()
    w = torch.from_numpy(rng.randn(3, 3, 3)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: Depthwise3x3Fn.apply(a, b, stride),
                                    (x, w))


def test_dx_skipped_without_input_grad(monkeypatch):
    """Only the filter needs a gradient: dx is not computed."""
    calls = []
    plain_dx = tdw.depthwise3x3_dx_plain
    monkeypatch.setattr(tdw, "depthwise3x3_dx_plain",
                        lambda *a: calls.append(a) or plain_dx(*a))
    w = torch.randn(4, 3, 3, requires_grad=True)
    (dw,) = torch.autograd.grad(depthwise3x3(torch.randn(1, 6, 6, 4), w, 2).sum(), (w,))
    assert dw.shape == (4, 3, 3) and calls == []
    x = torch.randn(1, 6, 6, 4, requires_grad=True)
    torch.autograd.grad(depthwise3x3(x, w, 2).sum(), (x,))
    assert len(calls) == 1


def test_bf16_gradients_follow_the_dtypes():
    """bf16 x and g: dx comes out bf16, dw fp32, both equal to the fp32
    computation on the same bf16-exact values (products exact in fp32)."""
    rng = np.random.RandomState(0)
    x = (rng.randint(-8, 8, (2, 7, 7, 8)) / 4.0).astype(np.float32)
    w = (rng.randint(-8, 8, (8, 3, 3)) / 8.0).astype(np.float32)
    g = (rng.randint(-8, 8, (2, 4, 4, 8)) / 4.0).astype(np.float32)
    xb, gb = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    dx = depthwise3x3_dx(gb, torch.from_numpy(w), 2, 7, 7)
    dw = depthwise3x3_dw(xb, gb, 2)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    want_dx = depthwise3x3_dx(torch.from_numpy(g), torch.from_numpy(w), 2, 7, 7)
    want_dw = depthwise3x3_dw(torch.from_numpy(x), torch.from_numpy(g), 2)
    np.testing.assert_array_equal(dx.float().numpy(), want_dx.bfloat16().float().numpy())
    np.testing.assert_array_equal(dw.numpy(), want_dw.numpy())


def test_backward_wrappers_reject_bad_arguments():
    g = torch.randn(2, 4, 4, 3)
    w = torch.randn(3, 3, 3)
    x = torch.randn(2, 8, 8, 3)
    with pytest.raises(ValueError, match="stride"):
        depthwise3x3_dx(g, w, 3, 8, 8)
    with pytest.raises(ValueError, match=r"\(2, 8, 8, 3\)"):
        depthwise3x3_dx(g, w, 1, 8, 8)  # stride 1 wants g of (2, 8, 8, 3)
    with pytest.raises(ValueError, match=r"\(3, 3, 3\)"):
        depthwise3x3_dx(g, torch.randn(4, 3, 3), 2, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        depthwise3x3_dx(g.transpose(1, 2), w, 2, 8, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        depthwise3x3_dw(x.half(), g.half(), 2)
    with pytest.raises(ValueError, match="g must be"):
        depthwise3x3_dw(x, g.bfloat16(), 2)
    with pytest.raises(ValueError, match="g must be"):
        depthwise3x3_dw(x, g[:1].contiguous(), 2)


def test_cpu_backward_counts_no_launch():
    before = (depthwise3x3.launches, depthwise3x3_dx.launches, depthwise3x3_dw.launches)
    x = torch.randn(1, 5, 5, 3, requires_grad=True)
    w = torch.randn(3, 3, 3, requires_grad=True)
    depthwise3x3(x, w, 1).sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    assert (depthwise3x3.launches, depthwise3x3_dx.launches,
            depthwise3x3_dw.launches) == before


@pytest.mark.parametrize("N,Ho,C,sms,want", [
    (64, 56, 64, 132, 528),    # 2 channel tiles: 8 blocks per SM
    (64, 7, 512, 132, 49),     # 16 tiles, but at least 64 pixels a band
    (1, 1, 3, 132, 1),
    (64, 28, 128, 132, 264),
])
def test_dw_bands(N, Ho, C, sms, want):
    assert dw_bands(N, Ho, Ho, C, sms) == want
