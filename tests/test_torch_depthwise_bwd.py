"""The port's depthwise 3x3 backward (on CPU: the plain dx and dw versions,
directly and through ``Depthwise3x3Fn``) against ``jax.vjp`` of the JAX
package's Pallas kernel in interpret mode, finite differences in float64,
the wrappers' argument checks, and the kernels' routes, strip and band rules
by shape (what the card would launch).

Tolerances, as the JAX package's own backward test
(tests/test_pallas_kernels.py): dx rtol/atol 1e-4; dw rtol 1e-4, atol 1e-3
(dw sums N*Ho*Wo products per tap, in another order on each side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import dorknet_tpu.ops.pallas.depthwise as pdw  # noqa: E402

import dorknet_tpu_torch.ops.cuda.depthwise as tdw  # noqa: E402
from dorknet_tpu_torch.ops.cuda.depthwise import (  # noqa: E402
    Depthwise3x3Fn, _dwgrad_route, _dx_route, depthwise3x3, depthwise3x3_dw, depthwise3x3_dx,
    dw_bands, dw_strip, dw_vec_bands, launch_dw, launch_dx)


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


@pytest.mark.parametrize("C,stride", [(3, 1), (8, 2)])
def test_cpu_backward_counts_no_launch(C, stride):
    """Neither the launch counts nor the per-route counts (both routes
    listed) move on the CPU, whatever route the card would take."""
    kernels = (depthwise3x3, depthwise3x3_dx, depthwise3x3_dw)
    before = [(k.launches, dict(k.launches_by_route)) for k in kernels]
    x = torch.randn(1, 6, 6, C, requires_grad=True)
    w = torch.randn(C, 3, 3, requires_grad=True)
    depthwise3x3(x, w, stride).sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    assert all(set(by) == {"scalar", "vector"} for _, by in before)
    assert [(k.launches, dict(k.launches_by_route)) for k in kernels] == before


@pytest.mark.parametrize("N,Ho,C,sms,want", [
    (64, 56, 64, 132, 528),    # 2 channel tiles: 8 blocks per SM
    (64, 7, 512, 132, 49),     # 16 tiles, but at least 64 pixels a band
    (1, 1, 3, 132, 1),
    (64, 28, 128, 132, 264),
])
def test_dw_bands(N, Ho, C, sms, want):
    assert dw_bands(N, Ho, Ho, C, sms) == want


def _act(shape, dtype, offset=0):
    """A contiguous NHWC CPU tensor starting ``offset`` elements into its
    storage (torch.empty: the routes read the shape, type and pointer)."""
    n = int(np.prod(shape))
    return torch.empty(n + offset, dtype=dtype)[offset:].view(*shape)


FLAGSHIP = [(H, C, s) for H, C, s, _ in chip_smoke.FLAGSHIP_DW]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,C,stride", FLAGSHIP + list(chip_smoke.ODD_DW))
def test_flagship_gradients_take_the_vector_routes(H, C, stride, dtype):
    """Every flagship depthwise layer at batch 64, and the odd 9x9x24: dx
    and dw on their channel-vector routes, in fp32 and bf16."""
    Ho = (H - 1) // stride + 1
    x, g = _act((64, H, H, C), dtype), _act((64, Ho, Ho, C), dtype)
    assert _dx_route(g) == "vector"
    assert _dwgrad_route(x, g) == "vector"


@pytest.mark.parametrize("C,dtype,x_off,g_off,dx_want,dw_want", [
    (6, torch.float32, 0, 0, "scalar", "scalar"),     # C not a multiple of 4
    (6, torch.bfloat16, 0, 0, "scalar", "scalar"),
    (3, torch.float32, 0, 0, "scalar", "scalar"),
    (12, torch.bfloat16, 0, 0, "scalar", "vector"),   # dx wants 8 bf16, dw 4
    (12, torch.float32, 0, 0, "vector", "vector"),
    (64, torch.float32, 0, 1, "scalar", "scalar"),    # g 4 bytes off
    (64, torch.float32, 1, 0, "vector", "scalar"),    # x off: dx reads only g
    (64, torch.bfloat16, 0, 4, "scalar", "vector"),   # g 8 bytes off: dw's 4 bf16 load
    (64, torch.bfloat16, 2, 0, "vector", "scalar"),   # x 4 bytes off
    (64, torch.bfloat16, 0, 1, "scalar", "scalar"),   # g 2 bytes off
])
def test_gradient_routes_by_shape_and_alignment(C, dtype, x_off, g_off, dx_want, dw_want):
    """dx takes the forward's rule on g (16-byte vectors: 4 fp32 or 8 bf16,
    g 16-byte aligned); dw takes 4 channels a thread (x and g aligned to 16
    bytes in fp32, 8 in bf16), checked on both pointers, since autograd's
    g.contiguous() may be an offset view."""
    x, g = _act((2, 9, 9, C), dtype, x_off), _act((2, 9, 9, C), dtype, g_off)
    assert _dx_route(g) == dx_want
    assert _dwgrad_route(x, g) == dw_want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,C,stride", FLAGSHIP)
def test_dx_strip_at_the_flagship(H, C, stride, dtype):
    """dx's strip is ``dw_strip`` over dx's own (N, H, W): 8 at every
    flagship layer at batch 64 on an H100's 132 SMs, in fp32 and bf16, and
    the strips still give the card at least 128 threads an SM."""
    vectors = C // (4 if dtype == torch.float32 else 8)
    tw = dw_strip(64, H, H, vectors, 132)
    assert tw == 8
    assert 64 * H * -(-H // tw) * vectors >= 128 * 132


@pytest.mark.parametrize("N,H,C,stride,rows,want", [
    (64, 56, 64, 1, 1, 528),   # 1 tile of 16 vectors, 8 lanes: 4 blocks an SM
    (64, 28, 128, 1, 1, 528),
    (64, 14, 256, 1, 1, 264),  # 2 tiles
    (64, 7, 512, 1, 1, 112),   # 4 tiles; 448 strips, 4 lanes: one strip a lane
    (64, 56, 64, 2, 1, 528),
    (64, 28, 128, 2, 1, 448),  # 1,792 strips over 4 lanes
    (64, 14, 256, 2, 1, 112),
    (4, 9, 24, 1, 1, 3),       # 6 vectors, 21 lanes, 72 strips
    (1, 1, 4, 1, 1, 1),
    # bf16: strips of two output rows
    (64, 56, 64, 1, 2, 528),
    (64, 14, 256, 1, 2, 224),  # 896 strips over 4 lanes
    (64, 7, 512, 1, 2, 64),    # 256 strips
    (64, 14, 256, 2, 2, 64),
])
def test_dw_vec_bands(N, H, C, stride, rows, want):
    """dw's vector route: about 4 blocks of 128 threads an SM (132 SMs),
    but every lane of a block walks at least one strip of ``rows`` by 8
    outputs."""
    Ho = (H - 1) // stride + 1
    P = dw_vec_bands(N, Ho, Ho, C, 132, rows)
    assert P == want
    vectors = C // 4
    tile = min(vectors, 32)
    lanes = 128 // tile
    strips = N * -(-Ho // rows) * -(-Ho // 8)
    assert P == 1 or strips // P >= lanes
    assert P * -(-vectors // tile) <= 4 * 132 + -(-vectors // tile)


def test_launchers_check_route_and_device():
    """launch_dx and launch_dw take the route by name and run on CUDA
    tensors only; the public wrappers never hand them a CPU tensor."""
    g, w, x = torch.randn(2, 4, 4, 8), torch.randn(8, 3, 3), torch.randn(2, 8, 8, 8)
    with pytest.raises(ValueError, match="route"):
        launch_dx(g, w, 2, 8, 8, "diagonal")
    with pytest.raises(ValueError, match="route"):
        launch_dw(x, g, 2, "fused")
    with pytest.raises(ValueError, match="unsupported device"):
        launch_dx(g, w, 2, 8, 8, "vector")
    with pytest.raises(ValueError, match="unsupported device"):
        launch_dw(x, g, 2, "scalar")
