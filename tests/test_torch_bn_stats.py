"""Batch-norm statistics: the port's ``batch_norm_stats`` (its plain version,
the CPU path of the wrapper) against the JAX package's Pallas kernel in
interpret mode, the train-mode batch norm that now takes its statistics from
it, and the launch count of a training step.

Tolerances as ``tests/test_pallas_kernels.py``: mean rtol/atol 1e-5, var
1e-4 (fp32 sums in different orders, and the one-pass variance's
cancellation on shifted inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from dorknet_tpu.ops.norm import batch_norm_train as jax_bn_train  # noqa: E402
from dorknet_tpu.ops.pallas.bn_stats import batch_norm_stats as jax_bn_stats  # noqa: E402

import dorknet_tpu_torch.ops.norm as norm  # noqa: E402
from dorknet_tpu_torch.models import ResNet18  # noqa: E402
from dorknet_tpu_torch.network import Trainer  # noqa: E402
from dorknet_tpu_torch.ops.cuda.bn_stats import batch_norm_stats, stats_bands  # noqa: E402
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402
from tests.test_torch_trainer import batches  # noqa: E402

MEAN_TOL = dict(rtol=1e-5, atol=1e-5)
VAR_TOL = dict(rtol=1e-4, atol=1e-4)


def _case(name):
    rng = np.random.RandomState(len(name))
    if name == "scaled":  # test_bn_stats_matches_numpy
        return (rng.randn(4, 9, 9, 16) * 3 + 1.5).astype(np.float32), torch.float32
    if name == "nonaligned":  # test_bn_stats_nonaligned_rows: 100 rows, not 512
        return (rng.randn(4, 5, 5, 8) + 7.0).astype(np.float32), torch.float32
    if name == "2d":
        return (rng.randn(37, 24) * 2 - 0.5).astype(np.float32), torch.float32
    # bf16: values that bf16 holds exactly, so both packages see the same x
    x = torch.from_numpy((rng.randn(4, 9, 9, 16) * 3 + 1.5).astype(np.float32))
    return x.bfloat16().float().numpy(), torch.bfloat16


@pytest.mark.parametrize("name", ["scaled", "nonaligned", "2d", "bf16"])
def test_batch_norm_stats_matches_jax_kernel(name):
    x, dtype = _case(name)
    xt = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jmean, jvar = jax_bn_stats(jx, interpret=True)
    mean, var = batch_norm_stats(xt)
    assert mean.dtype == var.dtype == torch.float32 and mean.shape == (x.shape[-1],)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), **MEAN_TOL)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), **VAR_TOL)
    x64 = x.reshape(-1, x.shape[-1]).astype(np.float64)
    np.testing.assert_allclose(mean.numpy(), x64.mean(0), **MEAN_TOL)
    np.testing.assert_allclose(var.numpy(), x64.var(0), **VAR_TOL)


@pytest.mark.parametrize("x,error,match", [
    (torch.zeros(4, 6, 8).transpose(1, 2), ValueError, "contiguous"),
    (torch.zeros(4, 8, dtype=torch.float64), TypeError, "float32 or bfloat16"),
    (torch.zeros(4, 8, dtype=torch.int32), TypeError, "float32 or bfloat16"),
    (torch.zeros(0, 8), ValueError, "rows and channels"),
])
def test_batch_norm_stats_checks_its_input(x, error, match):
    with pytest.raises(error, match=match):
        batch_norm_stats(x)


def test_stats_bands():
    """About eight blocks per SM, bands of 64..2048 rows, never more bands
    than rows: the stem's 802,816 rows x 64 channels on 132 SMs take 528
    bands of about 1,520 rows; 3,136 rows x 512 channels take 49 of 64."""
    assert stats_bands(802816, 64, 132) == 528
    assert stats_bands(3136, 512, 132) == 49
    assert stats_bands(100, 8, 132) == 2
    assert stats_bands(3, 1, 132) == 1
    assert stats_bands(10 ** 9, 64, 132) == 65535
    assert stats_bands(5 * 10 ** 6, 512, 132) == -(-5 * 10 ** 6 // 2048)


def _counting(monkeypatch):
    """Count the calls of the wrapper that ops/norm.py makes, and record the
    shapes of their inputs."""
    seen = []

    def counted(x):
        seen.append(tuple(x.shape))
        return batch_norm_stats(x)

    monkeypatch.setattr(norm, "batch_norm_stats", counted)
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("initialized", [False, True])
@pytest.mark.parametrize("shape", [(4, 5, 5, 8), (6, 12)])
def test_batch_norm_train_matches_jax_through_the_wrapper(monkeypatch, shape, initialized,
                                                          dtype):
    """The port's train-mode BN (its _BNCore) takes its statistics from one
    call of batch_norm_stats and gives the JAX batch_norm_train's y and
    running stats. bf16 x: the same bf16-exact values in both packages, the
    statistics compared in fp32, y within one bf16 step (2^-7 relative)."""
    seen = _counting(monkeypatch)
    rng = np.random.RandomState(sum(shape) + initialized)
    C = shape[-1]
    x = torch.from_numpy((rng.randn(*shape) * 2 + 0.5).astype(np.float32)).to(dtype)
    gamma, beta, rmean = ((1.0 + 0.1 * rng.randn(C)).astype(np.float32),
                          (0.1 * rng.randn(C)).astype(np.float32),
                          (0.1 * rng.randn(C)).astype(np.float32))
    rstd = rng.uniform(0.5, 1.5, C).astype(np.float32)
    y, m, s = norm.batch_norm_train(x, *(torch.from_numpy(a) for a in (gamma, beta, rmean, rstd)),
                                    initialized=initialized)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jy, jm, js = jax_bn_train(jnp.asarray(x.float().numpy(), jdt), *map(jnp.asarray, (
        gamma, beta, rmean, rstd)), initialized=initialized)
    assert seen == [shape] and y.dtype == dtype
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **MEAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **MEAN_TOL)
    ytol = dict(rtol=2 ** -7, atol=1e-5) if dtype == torch.bfloat16 else MEAN_TOL
    np.testing.assert_allclose(y.float().detach().numpy(), np.asarray(jy, np.float32), **ytol)


def test_resnet18_step_takes_34_batch_norm_stats(monkeypatch):
    """One Trainer.step of ResNet18 at 49 px (the JAX parity size) calls
    batch_norm_stats once for each of its 34 train-mode batch norms."""
    seen = _counting(monkeypatch)
    np.random.seed(0)
    net = ResNet18("dogs", num_classes=120)
    trainer = Trainer(net, SGDMomentum(net, 0.05 * 2 / 200, 0.9), device="cpu")
    X, y = batches(1, 1, 2, 49, 120)
    loss, _ = trainer.step(X[0], y[0])
    assert np.isfinite(float(loss))
    assert len(seen) == 34


def test_flagship_bn_table_matches_the_model(monkeypatch):
    """chip_smoke.py's table of the flagship's 34 batch-norm inputs, (H, C,
    how many), is what a train-mode pass of ResNet18 at 225 px feeds
    batch_norm_stats."""
    seen = _counting(monkeypatch)
    np.random.seed(0)
    net = ResNet18("dogs", num_classes=120)
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 225, 225, 3).astype(np.float32))
    net._train_forward(x)
    got = {}
    for shape in seen:
        _, H, W, C = shape
        assert H == W
        got[(H, C)] = got.get((H, C), 0) + 1
    assert got == {(H, C): n for H, C, n in chip_smoke.FLAGSHIP_BN}
    assert sum(got.values()) == 34
