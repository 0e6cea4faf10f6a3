"""The GEMM kernels' functions: the port's ``matmul`` and ``matmul_bn_stats``
(their plain versions, the CPU path of the wrappers) against the JAX
package's Pallas kernels in interpret mode, at the cases of
``tests/test_pallas_kernels.py``, and the wrappers' input checks.

Tolerances as there: y rtol/atol 1e-4, mean 1e-4, var 1e-3 (fp32 sums over
K and M in different orders); bf16 inputs: both packages form the same
exact fp32 products, so the statistics agree to fp32 summation order (mean
1e-5, var 1e-4) and y to one bf16 step."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from dorknet_tpu.ops.pallas.matmul import matmul as jax_matmul  # noqa: E402
from dorknet_tpu.ops.pallas.matmul import matmul_bn_stats as jax_mm_stats  # noqa: E402

from dorknet_tpu_torch.models import ResNet18  # noqa: E402
from dorknet_tpu_torch.ops.cuda.matmul import matmul, matmul_bn_stats  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M,K,N", [(64, 32, 48), (300, 512, 120), (8, 16, 128)])
def test_matmul_matches_jax(M, K, N):
    rng = np.random.RandomState(M + K + N)
    a = rng.randn(M, K).astype(np.float32)
    b = rng.randn(K, N).astype(np.float32)
    want = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), a @ b, **TOL)


@pytest.mark.parametrize("M,K,N,bm,bn", [
    (64, 32, 48, 512, 256),     # single tile, ragged N
    (300, 64, 120, 64, 128),    # several tiles on both axes, ragged M and N
    (8, 16, 128, 512, 256),     # tiny M
])
def test_matmul_bn_stats_matches_jax(M, K, N, bm, bn):
    """The fused function: y in a's dtype, the statistics unpolluted by the
    JAX kernel's tile padding or by the port's ragged edges."""
    rng = np.random.RandomState(0)
    a = rng.randn(M, K).astype(np.float32)
    b = rng.randn(K, N).astype(np.float32)
    jy, jmean, jvar = jax_mm_stats(jnp.asarray(a), jnp.asarray(b), bm=bm, bn=bn,
                                   interpret=True)
    y, mean, var = matmul_bn_stats(torch.from_numpy(a), torch.from_numpy(b))
    assert y.dtype == torch.float32 and y.shape == (M, N) and mean.shape == var.shape == (N,)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-3, atol=1e-3)
    ref = (a.astype(np.float64) @ b.astype(np.float64))
    np.testing.assert_allclose(mean.numpy(), ref.mean(0), **TOL)
    np.testing.assert_allclose(var.numpy(), ref.var(0), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_matmul_bn_stats_bf16_inputs(out_dtype):
    """bf16 a and b: y in bf16 by default (fp32 when asked); the statistics
    come from the fp32 product, not from the rounded y, in both packages."""
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randn(96, 32).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.randn(32, 128).astype(np.float32)).bfloat16()
    jdt = None if out_dtype is None else jnp.float32
    jy, jmean, jvar = jax_mm_stats(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                                   jnp.asarray(b.float().numpy(), jnp.bfloat16),
                                   out_dtype=jdt, interpret=True)
    y, mean, var = matmul_bn_stats(a, b, out_dtype=out_dtype)
    assert y.dtype == (torch.bfloat16 if out_dtype is None else torch.float32)
    assert jy.dtype == (jnp.bfloat16 if out_dtype is None else jnp.float32)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-4, atol=1e-4)
    ytol = dict(rtol=2 ** -7, atol=1e-5) if out_dtype is None else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), **ytol)
    exact = a.double() @ b.double()
    np.testing.assert_allclose(mean.numpy(), exact.mean(0).numpy(), rtol=1e-5, atol=1e-5)
    if out_dtype is None:
        rounded = y.double().mean(0)
        assert float((mean.double() - exact.mean(0)).abs().max()) < \
            float((rounded - exact.mean(0)).abs().max())


@pytest.mark.parametrize("fn,a,b,kwargs,error,match", [
    (matmul, torch.zeros(4, 8), torch.zeros(16, 8).t(), {}, ValueError, "contiguous"),
    (matmul, torch.zeros(4, 8), torch.zeros(8, 16).bfloat16(), {}, TypeError, "or both bfloat16"),
    (matmul, torch.zeros(4, 8).double(), torch.zeros(8, 16).double(), {}, TypeError,
     "or both bfloat16"),
    (matmul, torch.zeros(4, 8), torch.zeros(9, 16), {}, ValueError, r"\(M,K\)"),
    (matmul_bn_stats, torch.zeros(4, 8), torch.zeros(8, 16), dict(out_dtype=torch.float16),
     TypeError, "out_dtype"),
    (matmul_bn_stats, torch.zeros(0, 8), torch.zeros(8, 16), {}, ValueError, "rows"),
])
def test_wrappers_check_their_inputs(fn, a, b, kwargs, error, match):
    with pytest.raises(error, match=match):
        fn(a, b, **kwargs)


def test_flagship_pointwise_table_matches_the_model(monkeypatch):
    """chip_smoke.py's table of the flagship's 20 pointwise GEMMs, (H*W, K,
    N, how many) per image, and its dense head, are the products a forward
    of ResNet18 at 225 px hands torch.matmul."""
    seen = []
    real = torch.matmul

    def recording(x, w):
        seen.append((x.numel() // x.shape[-1], x.shape[-1], w.shape[-1]))
        return real(x, w)

    monkeypatch.setattr(torch, "matmul", recording)
    np.random.seed(0)
    net = ResNet18("dogs", num_classes=120)
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 225, 225, 3).astype(np.float32))
    net._train_forward(x)
    got = {}
    for shape in seen[:-1]:
        got[shape] = got.get(shape, 0) + 1
    assert got == {(hw, K, N): n for hw, K, N, n in chip_smoke.FLAGSHIP_PW}
    assert sum(got.values()) == 20
    assert seen[-1] == (1,) + chip_smoke.FLAGSHIP_DENSE[1:]
