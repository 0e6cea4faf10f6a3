"""The training ops of the port against their ``dorknet_tpu`` counterparts on
the same numpy inputs: train-mode batch norm (output, statistics, the
first-batch adopt and the EMA, and gradients under a random cotangent), the
softmax cross-entropy with its pinned (p - y)/B gradient, the l2
regulariser, and the three optimisers' update rules.

Tolerances (fp32 on both sides, sums in different orders): rtol/atol 1e-5,
or 1e-4 where a gradient passes through batch norm's 1/σ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dorknet_tpu.ops.loss import softmax_cross_entropy as jax_sce  # noqa: E402
from dorknet_tpu.ops.norm import batch_norm_train as jax_bn_train  # noqa: E402
from dorknet_tpu.optimisers import RMSProp as JaxRMSProp  # noqa: E402
from dorknet_tpu.optimisers import SGD as JaxSGD  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402
from dorknet_tpu.regularisers.l2 import l2 as jax_l2  # noqa: E402

from dorknet_tpu_torch.layers import BatchNormLayer  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork  # noqa: E402
from dorknet_tpu_torch.ops.loss import softmax_cross_entropy  # noqa: E402
from dorknet_tpu_torch.ops.norm import batch_norm_train  # noqa: E402
from dorknet_tpu_torch.optimisers import RMSProp, SGD, SGDMomentum  # noqa: E402
from dorknet_tpu_torch.regularisers.l2 import l2  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _bn_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    C = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.randn(C)).astype(np.float32)
    beta = (0.1 * rng.randn(C)).astype(np.float32)
    rmean = (0.1 * rng.randn(C)).astype(np.float32)
    rstd = rng.uniform(0.5, 1.5, C).astype(np.float32)
    ct = rng.randn(*shape).astype(np.float32)
    return x, gamma, beta, rmean, rstd, ct


@pytest.mark.parametrize("initialized", [False, True])
@pytest.mark.parametrize("shape", [(4, 5, 5, 8), (6, 12)])
def test_batch_norm_train(shape, initialized):
    """y and the new running stats; the gradients of x, gamma and beta under
    a random cotangent of y; the stats take no gradient."""
    x, gamma, beta, rmean, rstd, ct = _bn_inputs(shape, seed=len(shape) * 10 + initialized)

    def jax_fn(x_, g_, b_):
        y, m, s = jax_bn_train(x_, g_, b_, jnp.asarray(rmean), jnp.asarray(rstd),
                               momentum=0.95, eps=1e-5, initialized=initialized)
        return jnp.sum(y * jnp.asarray(ct)), (y, m, s)

    (_, (jy, jm, js)), jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))

    xt, gt, bt = (_t(a).requires_grad_() for a in (x, gamma, beta))
    y, m, s = batch_norm_train(xt, gt, bt, _t(rmean), _t(rstd), momentum=0.95,
                               eps=1e-5, initialized=initialized)
    assert not m.requires_grad and not s.requires_grad
    grads = torch.autograd.grad(y, (xt, gt, bt), _t(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    for got, want in zip(grads, jgrads, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    axes = tuple(range(len(shape) - 1))
    batch_mean = x.astype(np.float64).mean(axis=axes)
    if initialized:
        np.testing.assert_allclose(m.numpy(), 0.95 * rmean + 0.05 * batch_mean,
                                   rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(m.numpy(), batch_mean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(s.numpy(), np.sqrt(x.var(axis=axes) + 1e-5), rtol=1e-5)


def test_batch_norm_train_bf16_flow():
    """bf16 x: y and dx come out bf16, the statistics and the gamma/beta
    gradients in fp32 (compared with the fp32 computation on the same
    bf16-exact x, loosely: y and dx are rounded to bf16)."""
    x, gamma, beta, rmean, rstd, ct = _bn_inputs((4, 3, 3, 8), seed=3)
    x = (np.round(x * 4) / 4).astype(np.float32)
    xb = _t(x).bfloat16().requires_grad_()
    y, m, s = batch_norm_train(xb, _t(gamma), _t(beta), _t(rmean), _t(rstd),
                               initialized=False)
    assert y.dtype == torch.bfloat16 and m.dtype == torch.float32
    (dx,) = torch.autograd.grad(y, (xb,), _t(ct).bfloat16())
    assert dx.dtype == torch.bfloat16
    y32, m32, _ = batch_norm_train(_t(x), _t(gamma), _t(beta), _t(rmean), _t(rstd),
                                   initialized=False)
    np.testing.assert_allclose(m.numpy(), m32.numpy(), **TOL)
    np.testing.assert_allclose(y.float().detach().numpy(), y32.detach().numpy(),
                               rtol=1e-2, atol=2e-2)


def test_batch_norm_layer_adopts_then_takes_the_ema():
    """The layer: unset before its first train batch, which it adopts; the
    second batch is folded in at momentum 0.95; the stats stay in the
    reference's (1,C,1,1) shape and a test-mode pass then works."""
    bn = BatchNormLayer("bn", incoming_chans=8)
    rng = np.random.RandomState(0)
    x1, x2 = (_t(rng.randn(4, 5, 5, 8) + 1.0) for _ in range(2))
    assert not bn.bn_initialized()
    bn.fapply(x1, train=True)
    assert bn.bn_initialized() and bn.running_mean.shape == (1, 8, 1, 1)
    m1 = x1.mean(dim=(0, 1, 2))
    np.testing.assert_allclose(bn.running_mean.reshape(-1).numpy(), m1.numpy(), **TOL)
    bn.fapply(x2, train=True)
    np.testing.assert_allclose(bn.running_mean.reshape(-1).numpy(),
                               (0.95 * m1 + 0.05 * x2.mean(dim=(0, 1, 2))).numpy(), **TOL)
    assert not bn.running_mean.requires_grad
    assert bn.fapply(x1).shape == x1.shape


@pytest.mark.parametrize("soft", [False, True])
def test_softmax_cross_entropy(soft):
    """Value mean(-log(p·y)); gradient pinned to (p - y)/B, which for soft
    labels is not the value's own gradient."""
    rng = np.random.RandomState(int(soft))
    logits = (3.0 * rng.randn(5, 7)).astype(np.float32)
    if soft:
        y = rng.uniform(0.0, 1.0, (5, 7)).astype(np.float32)
        y /= y.sum(axis=1, keepdims=True)
    else:
        y = np.eye(7, dtype=np.float32)[rng.randint(0, 7, 5)]
    jloss, jgrad = jax.value_and_grad(jax_sce)(jnp.asarray(logits), jnp.asarray(y))
    lt = _t(logits).requires_grad_()
    loss = softmax_cross_entropy(lt, _t(y))
    (grad,) = torch.autograd.grad(loss * 2.0, (lt,))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), 2.0 * np.asarray(jgrad), **TOL)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    np.testing.assert_allclose(grad.numpy(), 2.0 * (p - y) / 5, **TOL)


def test_l2():
    w = np.random.RandomState(0).randn(6, 4).astype(np.float32)
    np.testing.assert_allclose(float(l2(0.01).forward(_t(w))),
                               float(jax_l2(0.01).forward(jnp.asarray(w))), rtol=1e-6)
    np.testing.assert_allclose(l2(0.01).backward(_t(w)).numpy(),
                               np.asarray(jax_l2(0.01).backward(jnp.asarray(w))), rtol=1e-6)
    wt = _t(w).requires_grad_()
    (g,) = torch.autograd.grad(l2(0.01).forward(wt), (wt,))
    np.testing.assert_allclose(g.numpy(), 0.01 * w, rtol=1e-6)


@pytest.mark.parametrize("name", ["SGD", "SGDMomentum", "RMSProp"])
def test_optimiser_apply_update_matches_jax(name):
    """Three updates from the same params, grads and state: params and
    state after each (the velocity and accumulator forms of the JAX
    package)."""
    make = {
        "SGD": (lambda n: SGD(n, 0.1), lambda n: JaxSGD(n, 0.1)),
        "SGDMomentum": (lambda n: SGDMomentum(n, 0.1, 0.9),
                        lambda n: JaxSGDMomentum(n, 0.1, 0.9)),
        "RMSProp": (lambda n: RMSProp(n, 0.01, 0.9), lambda n: JaxRMSProp(n, 0.01, 0.9)),
    }[name]
    opt = make[0](FeedForwardNetwork("empty"))
    jopt = make[1](_EmptyJaxNetwork())
    rng = np.random.RandomState(1)
    shapes = [(3, 4), (5,), (2, 3, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    # copies on both sides: the torch update is in place, and a JAX CPU
    # array may share a numpy array's memory
    tparams = [_t(p).clone() for p in params]
    jparams = [jnp.array(p, copy=True) for p in params]
    cache = opt.init_cache(tparams)
    jcache = jopt.init_cache(jparams) if name != "SGD" else [{} for _ in params]
    for _ in range(3):
        grads = [rng.randn(*s).astype(np.float32) for s in shapes]
        with torch.no_grad():
            cache = opt.apply_update(tparams, [_t(g) for g in grads], cache, opt.learning_rate)
        jparams, jcache = jopt.apply_update(jparams, [jnp.asarray(g) for g in grads],
                                            jcache, jnp.float32(jopt.learning_rate))
        for got, want in zip(tparams, jparams, strict=True):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        if name != "SGD":
            for got, want in zip(cache, jcache, strict=True):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)


class _EmptyJaxNetwork:
    """What the JAX optimisers' constructors read of a network."""
    layers = []
    _version = 0


def test_learning_rate_api_and_update_weights_needs_backward():
    net = FeedForwardNetwork("n")
    net.add_layer(BatchNormLayer("bn", input_dimension=2, incoming_chans=3))
    opt = SGDMomentum(net, 0.1, 0.9)
    opt.set_learning_rate(0.2)
    opt.multiply_learning_rate(0.5)
    assert opt.learning_rate == pytest.approx(0.1)
    with pytest.raises(RuntimeError, match="backward"):
        opt.update_weights()
