"""Train-mode batch norm's normalise and backward (``ops/cuda/bn_train.py``,
the CPU path of the wrappers: their plain versions) against the JAX
package's ``_bn_core_fwd`` / ``_bn_core_bwd``, what ``_BNCore`` saves, the
wrappers' checks and the launch shapes they pick for the card.

Tolerances: fp32 1e-5 (sums in different orders; 1e-4 for gradients through
1/σ, as ``tests/test_torch_train_ops.py``); bf16 outputs within one bf16 step
(2^-7 relative) of the JAX package's, which rounds at the same places."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dorknet_tpu.ops.norm import _bn_core, _bn_core_bwd  # noqa: E402
from dorknet_tpu.ops.norm import batch_norm_train as jax_bn_train  # noqa: E402

import dorknet_tpu_torch.ops.norm as norm  # noqa: E402
from dorknet_tpu_torch.models import ResNet18  # noqa: E402
from dorknet_tpu_torch.network import Trainer  # noqa: E402
from dorknet_tpu_torch.ops.cuda import bn_train  # noqa: E402
from dorknet_tpu_torch.ops.cuda.bn_train import (  # noqa: E402
    bn_apply, bn_bwd_dx, bn_bwd_reduce, pointwise_threads, reduce_tiling, vector_width)
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402
from tests.test_torch_trainer import batches  # noqa: E402

EPS = 1e-5
FP32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2 ** -7, atol=1e-4)


def _inputs(shape, dtype, seed):
    """x (bf16-exact when dtype is bf16, so both packages see the same x),
    gamma, beta, running stats and a cotangent of y in x's dtype."""
    rng = np.random.RandomState(seed)
    C = shape[-1]
    x = torch.from_numpy((rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)).to(dtype)
    gy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    vec = [(1.0 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32),
           (0.1 * rng.randn(C)).astype(np.float32), rng.uniform(0.5, 1.5, C).astype(np.float32)]
    return x, gy, vec


def _jnp(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16
                       else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("lead", [(12,), (2, 3, 3)], ids=["2d", "4d"])
@pytest.mark.parametrize("C", [16, 24, 72, 200, 512, 13])
@pytest.mark.parametrize("initialized", [False, True])
def test_train_mode_bn_matches_jax(initialized, C, lead, dtype):
    """y and the running stats of the port's batch_norm_train (its _BNCore
    on the plain versions) equal the JAX batch_norm_train's; the gradients
    of x, gamma and beta under one cotangent equal the JAX _bn_core_bwd's on
    the residuals _bn_core_fwd saves, x^ in x's dtype, made from the port's
    own statistics; in fp32 also the whole JAX VJP's. (The two packages'
    means part in the last fp32 bit, so a bf16 x^ can round to the other
    neighbour in either: the bf16 backward takes one package's x^.)"""
    shape = lead + (C,)
    x, gy, (gamma, beta, rmean, rstd) = _inputs(shape, dtype, seed=C + len(lead) + initialized)
    jx, jgy = _jnp(x), _jnp(gy)
    jy, jm, js = jax_bn_train(jx, *map(jnp.asarray, (gamma, beta, rmean, rstd)),
                              eps=EPS, initialized=initialized)

    xt = x.clone().requires_grad_()
    gt, bt = (torch.from_numpy(a).requires_grad_() for a in (gamma, beta))
    y, m, s = norm.batch_norm_train(xt, gt, bt, torch.from_numpy(rmean), torch.from_numpy(rstd),
                                    eps=EPS, initialized=initialized)
    _, saved, _ = y.grad_fn.saved_tensors
    got = torch.autograd.grad(y, (xt, gt, bt), gy)
    assert y.dtype == got[0].dtype == dtype and got[1].dtype == torch.float32
    out = FP32 if dtype == torch.float32 else BF16
    np.testing.assert_allclose(y.detach().float().numpy(), np.asarray(jy, np.float32), **out)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **FP32)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **FP32)

    x_hat = (x.float() - saved[0]) * saved[1]
    res = (_jnp(x_hat.to(dtype)), jnp.asarray(saved[1].numpy()), jnp.asarray(gamma))
    wants = [_bn_core_bwd(EPS, res, (jgy, None, None))]
    if dtype == torch.float32:
        _, vjp = jax.vjp(lambda a, g, b: _bn_core(a, g, b, EPS)[0], jx, jnp.asarray(gamma),
                         jnp.asarray(beta))
        wants.append(vjp(jgy))
    for want in wants:
        for a, b, tol in zip(got, want, (out if dtype == torch.bfloat16 else GRAD, GRAD, GRAD),
                             strict=True):
            np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_bn_core_saves_x_not_x_hat(dtype):
    """The forward saves the x it was given (no copy) and only per-channel
    vectors besides: no activation-sized x̂."""
    x, _, (gamma, beta, _, _) = _inputs((2, 5, 5, 24), dtype, seed=5)
    x.requires_grad_()
    y, _, _ = norm._BNCore.apply(x, torch.from_numpy(gamma).requires_grad_(),
                                 torch.from_numpy(beta), EPS)
    saved = y.grad_fn.saved_tensors
    assert saved[0].data_ptr() == x.data_ptr() and saved[0].shape == x.shape
    assert all(t.numel() <= 2 * x.shape[-1] for t in saved[1:])


def test_expanded_gy_gives_the_same_gradients():
    """A non-contiguous (expanded) cotangent, as a sum's gradient arrives,
    gives the gradients of its contiguous copy."""
    x, _, (gamma, beta, _, _) = _inputs((3, 4, 4, 16), torch.float32, seed=6)
    gy = torch.from_numpy(np.random.RandomState(7).randn(16).astype(np.float32)).expand(x.shape)
    assert not gy.is_contiguous()
    grads = []
    for g in (gy, gy.contiguous()):
        xt = x.clone().requires_grad_()
        gt, bt = (torch.from_numpy(a).requires_grad_() for a in (gamma, beta))
        y, _, _ = norm._BNCore.apply(xt, gt, bt, EPS)
        grads.append(torch.autograd.grad(y, (xt, gt, bt), g))
    for a, b in zip(*grads, strict=True):
        assert torch.equal(a, b)


def _vectors(C):
    return [torch.ones(C) for _ in range(4)]


def _wrapper_calls(x):
    """Each wrapper called on x, with per-channel vectors of x's C."""
    C = x.shape[-1]
    mean, var, gamma, beta = _vectors(C)
    norm2, coef = torch.zeros(2, C), torch.zeros(3, C)
    return {
        "bn_apply": lambda: bn_apply(x, mean, var, gamma, beta, EPS),
        "bn_bwd_reduce": lambda: bn_bwd_reduce(x, x, norm2, gamma),
        "bn_bwd_dx": lambda: bn_bwd_dx(x, x, norm2, coef),
    }


@pytest.mark.parametrize("entry", ["bn_apply", "bn_bwd_reduce", "bn_bwd_dx"])
@pytest.mark.parametrize("x,error,match", [
    (torch.zeros(4, 8, dtype=torch.float16), TypeError, "float32 or bfloat16"),
    (torch.zeros(4, 6, 8).transpose(1, 2), ValueError, "contiguous"),
    (torch.zeros(4, 0), ValueError, "rows and channels"),
], ids=["fp16", "non_contiguous", "C0"])
def test_wrappers_check_their_input(entry, x, error, match):
    with pytest.raises(error, match=match):
        _wrapper_calls(x)[entry]()


@pytest.mark.parametrize("entry", ["bn_apply", "bn_bwd_reduce"])
def test_wrappers_refuse_a_gamma_of_the_wrong_length(entry):
    x = torch.zeros(4, 8)
    mean, var, gamma, beta = _vectors(8)
    short = torch.ones(7)
    call = {"bn_apply": lambda: bn_apply(x, mean, var, short, beta, EPS),
            "bn_bwd_reduce": lambda: bn_bwd_reduce(x, x, torch.zeros(2, 8), short)}[entry]
    with pytest.raises(ValueError, match="gamma must be contiguous float32 of shape"):
        call()


def test_backward_wrappers_refuse_a_mismatched_gy():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="gy must match"):
        bn_bwd_reduce(torch.zeros(4, 8, dtype=torch.bfloat16), x, torch.zeros(2, 8),
                      torch.ones(8))
    with pytest.raises(ValueError, match="gy must match"):
        bn_bwd_dx(torch.zeros(5, 8), x, torch.zeros(2, 8), torch.zeros(3, 8))


def test_launch_shapes():
    """On 132 SMs: 16-byte vectors where C allows; the pointwise grid a
    whole number of rows of channel vectors, about 2048 threads a SM; the
    reduction's tiles, lanes and bands (MobileNet-V3's C = 16 keeps all 256
    threads of a block busy: 4 vectors x 64 lanes)."""
    x32, xb = torch.zeros(4, 16), torch.zeros(4, 16, dtype=torch.bfloat16)
    assert vector_width(16, torch.float32, x32) == 4
    assert vector_width(16, torch.bfloat16, xb) == 8
    assert vector_width(24, torch.bfloat16, torch.zeros(4, 24, dtype=torch.bfloat16)) == 8
    assert vector_width(13, torch.float32, torch.zeros(4, 13)) == 1
    assert vector_width(12, torch.float32, torch.zeros(49)[1:].reshape(4, 12)) == 1  # offset 4 B
    sms = 132
    assert pointwise_threads(1_505_280, 64, 4, sms) == 270_336  # 16,896 rows of 16 vectors
    assert pointwise_threads(5_880, 240, 4, sms) == 270_300  # 4,505 rows of 60
    assert pointwise_threads(6, 960, 4, sms) == 6 * 240  # at most M rows
    assert pointwise_threads(10, 2048, 1, sms) == 10 * 2048
    assert reduce_tiling(1_605_632, 16, 4, sms) == (4, 64, 1056)
    assert reduce_tiling(1_505_280, 64, 4, sms) == (16, 16, 1056)
    assert reduce_tiling(6_272, 960, 4, sms) == (240, 1, 392)
    assert reduce_tiling(3_136, 2048, 4, sms) == (512, 1, 196)
    assert reduce_tiling(3_136, 2048, 8, sms) == (256, 1, 196)
    assert reduce_tiling(3_136, 2049, 1, sms) == (410, 1, 106)  # five balanced tiles
    assert reduce_tiling(12, 13, 1, sms) == (13, 19, 1)
    assert reduce_tiling(10 ** 9, 64, 4, sms) == (16, 16, 1056)


def test_resnet18_step_takes_34_of_each(monkeypatch):
    """One Trainer.step of ResNet18 at 49 px calls each wrapper once for
    each of its 34 train-mode batch norms."""
    calls = {name: 0 for name in ("bn_apply", "bn_bwd_reduce", "bn_bwd_dx")}

    def counting(name):
        fn = getattr(bn_train, name)

        def counted(*args):
            calls[name] += 1
            return fn(*args)
        return counted

    for name in calls:
        monkeypatch.setattr(norm, name, counting(name))
    np.random.seed(0)
    net = ResNet18("dogs", num_classes=120)
    trainer = Trainer(net, SGDMomentum(net, 0.05 * 2 / 200, 0.9), device="cpu")
    X, y = batches(1, 1, 2, 49, 120)
    loss, _ = trainer.step(X[0], y[0])
    assert np.isfinite(float(loss))
    assert calls == dict.fromkeys(calls, 34)
