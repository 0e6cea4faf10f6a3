"""The port's depthwise 3x3 (on CPU: its plain version) against the JAX
package's Pallas kernel in interpret mode and against its XLA path, plus the
dispatch by shape, the kernel's route by shape and the wrapper's argument
checks."""

import numpy as np
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import dorknet_tpu.ops.pallas.depthwise as pdw  # noqa: E402
from dorknet_tpu.ops.conv import depthwise_conv2d as jax_depthwise_conv2d  # noqa: E402

import dorknet_tpu_torch.ops.conv as tconv  # noqa: E402
from dorknet_tpu_torch.ops.cuda.depthwise import _dw_route, depthwise3x3, dw_strip  # noqa: E402

# fp32: the same nine products summed in another order (rtol/atol 1e-5).
# bf16: inputs on a bf16-exact grid, outputs rounded to bf16 by each side;
# compared in fp32 (rtol/atol 1e-2, as the JAX package's own bf16 test).
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(pdw, "_INTERPRET", True)


def _inputs(seed, H, C, dtype):
    rng = np.random.RandomState(seed)
    if dtype == "bfloat16":
        # bf16-representable values, so both sides start from the same inputs
        x = (rng.randint(-8, 8, (2, H, H, C)) / 4.0).astype(np.float32)
        w = (rng.randint(-8, 8, (C, 3, 3)) / 8.0).astype(np.float32)
    else:
        x = rng.randn(2, H, H, C).astype(np.float32)
        w = rng.randn(C, 3, 3).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    return x, w, b


def _as(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [8, 24])
@pytest.mark.parametrize("H", [9, 10])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise3x3_matches_pallas_kernel(stride, H, C, dtype):
    x, w, _ = _inputs(H * 100 + C, H, C, dtype)
    want = pdw.depthwise3x3(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w), stride)
    got = depthwise3x3(_as(x, dtype), torch.from_numpy(w), stride)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("C", [8, 24])
@pytest.mark.parametrize("H", [9, 10])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv2d_matches_xla_path(stride, H, C, with_bias, dtype):
    """Under the fp32 policy both packages upcast a bf16 input and return
    fp32."""
    x, w, b = _inputs(H * 100 + C + 1, H, C, dtype)
    bj = jnp.asarray(b) if with_bias else None
    bt = torch.from_numpy(b) if with_bias else None
    want = jax_depthwise_conv2d(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w),
                                bj, stride, 1)
    got = tconv.depthwise_conv2d(_as(x, dtype), torch.from_numpy(w), bt, stride, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("ksize,stride,padding,kernel", [
    (3, 1, 1, True), (3, 2, 1, True),
    (5, 1, 2, False), (5, 2, 2, False), (3, 1, 0, False), (3, 3, 1, False),
])
def test_depthwise_dispatch_by_shape(monkeypatch, ksize, stride, padding, kernel):
    """3x3 / pad 1 / stride 1-or-2 goes to the kernel's wrapper; any other
    shape to the grouped conv. Both agree with the JAX package."""
    calls = []

    def spy(x, w, s):
        calls.append(s)
        return depthwise3x3(x, w, s)

    monkeypatch.setattr(tconv, "depthwise3x3", spy)
    rng = np.random.RandomState(ksize * 10 + stride)
    x = rng.randn(2, 11, 11, 8).astype(np.float32)
    w = rng.randn(8, ksize, ksize).astype(np.float32)
    got = tconv.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(w), None,
                                 stride, padding)
    want = jax_depthwise_conv2d(jnp.asarray(x), jnp.asarray(w), None, stride, padding)
    assert calls == ([stride] if kernel else [])
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_depthwise3x3_rejects_bad_arguments():
    x = torch.randn(2, 8, 8, 4)
    w = torch.randn(4, 3, 3)
    with pytest.raises(ValueError, match="contiguous"):
        depthwise3x3(x.permute(0, 2, 1, 3), w, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        depthwise3x3(x.half(), w, 1)
    with pytest.raises(ValueError, match=r"\(4, 3, 3\)"):
        depthwise3x3(x, torch.randn(4, 5, 5), 1)
    with pytest.raises(ValueError, match="float32"):
        depthwise3x3(x, w.double(), 1)
    with pytest.raises(ValueError, match="stride"):
        depthwise3x3(x, w, 3)
    with pytest.raises(ValueError, match="N,H,W,C"):
        depthwise3x3(x[0], w, 1)


def test_depthwise3x3_cpu_counts_no_launch():
    """The launch count moves only where the CUDA kernel launches."""
    before = depthwise3x3.launches
    depthwise3x3(torch.randn(1, 5, 5, 3), torch.randn(3, 3, 3), 1)
    assert depthwise3x3.launches == before


def _act(shape, dtype, offset=0):
    """A contiguous NHWC CPU tensor starting ``offset`` elements into its
    storage (torch.empty: the route reads the shape, type and pointer)."""
    n = int(np.prod(shape))
    return torch.empty(n + offset, dtype=dtype)[offset:].view(*shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,C,stride", [(H, C, s) for H, C, s, _ in chip_smoke.FLAGSHIP_DW] +
                         list(chip_smoke.ODD_DW))
def test_dw_route_sends_the_flagship_layers_to_channel_vectors(H, C, stride, dtype):
    """All of the flagship's depthwise shapes at batch 64, and the odd
    9x9x24, take the 16-byte channel-vector route in fp32 and in bf16."""
    assert _dw_route(_act((64, H, H, C), dtype)) == "vector"


@pytest.mark.parametrize("C,dtype,offset", [
    (6, torch.float32, 0), (6, torch.bfloat16, 0),     # C not a multiple of the vector
    (12, torch.bfloat16, 0), (3, torch.float32, 0),
    (64, torch.float32, 1), (64, torch.bfloat16, 4),   # views that are not 16-byte aligned
])
def test_dw_route_keeps_the_rest_scalar(C, dtype, offset):
    assert _dw_route(_act((2, 9, 9, C), dtype, offset)) == "scalar"


@pytest.mark.parametrize("N,H,C,stride,want", [(64, H, C, s, 8) for H, C, s, _ in
                                                 chip_smoke.FLAGSHIP_DW] + [
    (8, 14, 256, 1, 4), (4, 56, 64, 2, 2), (1, 9, 24, 1, 1), (4, 14, 64, 1, 1),
])
def test_dw_strip_keeps_the_card_busy(N, H, C, stride, want):
    """The strip is the widest of 8, 4, 2 that still leaves 128 threads per
    SM of an H100 (132 SMs), in fp32: every flagship layer at batch 64 gets
    8; smaller layers get narrower strips."""
    Ho = (H - 1) // stride + 1
    tw = dw_strip(N, Ho, Ho, C // 4, 132)
    assert tw == want
    assert tw == 1 or N * Ho * -(-Ho // tw) * (C // 4) >= 128 * 132


def test_dw_routes_count_no_cpu_launch():
    before = dict(depthwise3x3.launches_by_route)
    depthwise3x3(torch.randn(1, 5, 5, 8), torch.randn(8, 3, 3), 1)
    assert set(before) == {"scalar", "vector"}
    assert depthwise3x3.launches_by_route == before
