"""``Trainer.accumulate_step`` against the JAX package's: K micro-batches,
one update, from the same fresh weights in both packages (after
``tests/test_network.py:216-276`` and ``tests/test_ema.py:85-88``).

- a narrow depthwise-separable net with batch norm, K = 2, two updates, on a
  fresh network (the BN pre-pass, with micro-batch 0 weighted twice in the
  running stats) and on one whose BN a first step set, in NCHW and NHWC;
- a BN-free net over distinct micro-batches, where the accumulated update
  equals one step on the concatenated batch;
- the EMA advances once per update.

Tolerances as ``tests/test_torch_trainer.py``: loss rtol 1e-5; parameters,
running stats and EMA rtol 1e-4 / atol 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.layers as jlayers  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.network import Trainer as JaxTrainer  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402
from dorknet_tpu.regularisers.l2 import l2 as jl2  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402
from dorknet_tpu_torch.regularisers.l2 import l2 as tl2  # noqa: E402
from tests.test_torch_trainer import assert_trees_close, batches, narrow_net  # noqa: E402


def _trainers(jnet, net, lr, **kwargs):
    return (JaxTrainer(jnet, JaxSGDMomentum(jnet, lr, 0.9), **kwargs),
            Trainer(net, SGDMomentum(net, lr, 0.9), device="cpu", **kwargs))


@pytest.mark.parametrize("bn,layout", [("fresh", "NCHW"), ("initialised", "NCHW"),
                                       ("fresh", "NHWC")])
def test_narrow_net_accumulate_matches_jax(bn, layout):
    """K = 2 micro-batches of 4 at 17x17, two updates, clip 1.0, EMA 0.9."""
    np.random.seed(21)
    jnet = narrow_net(jlayers, jl2, JaxNetwork)
    np.random.seed(21)
    net = narrow_net(tlayers, tl2, FeedForwardNetwork)
    jt, t = _trainers(jnet, net, 0.05, ema_decay=0.9, clip_norm=1.0, input_layout=layout)
    X, y = batches(22, 5, 4, 17, 10)
    if layout == "NHWC":
        X = np.ascontiguousarray(X.transpose(0, 1, 3, 4, 2))
    if bn == "initialised":
        jt.step(X[4], y[4])
        t.step(X[4], y[4])
    for k in range(2):
        Xs, ys = X[2 * k:2 * k + 2], y[2 * k:2 * k + 2]
        jloss = jt.accumulate_step(Xs, ys)
        loss = t.accumulate_step(Xs, ys)
        assert loss.shape == ()
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   err_msg="loss, update {}".format(k))
        assert_trees_close(net.gather_params(), jnet.gather_params(),
                           "params, update {}".format(k))
        assert_trees_close(net.gather_states(), jnet.gather_states(),
                           "BN running stats, update {}".format(k))
        assert_trees_close(t.ema_params(), jt.ema_params(), "EMA, update {}".format(k))


def _bn_free_net(L, l2, network_cls, seed):
    np.random.seed(seed)
    net = network_cls("bnfree")
    net.add_layer(L.ConvLayer("conv1", filter_block_shape=(8, 3, 3, 3), with_bias=True,
                              weight_regulariser=l2(1e-4), weight_initialiser="glorot_uniform"))
    net.add_layer(L.ReLu("relu1"))
    net.add_layer(L.GlobalAveragePoolingLayer("gap"))
    net.add_layer(L.DenseLayer("dense1", incoming_chans=8, output_dim=5,
                               weight_regulariser=l2(1e-4), weight_initialiser="glorot_uniform"))
    net.set_loss_layer(L.SoftmaxWithCrossEntropy("softmax"))
    return net


def test_bn_free_accumulate_matches_jax_and_the_big_batch():
    """Distinct micro-batches: the accumulated update equals the JAX
    package's and one step of the port on the concatenated batch (loss and
    gradient are batch means, so the mean of equal-sized micro-batches' is
    the big batch's)."""
    X, y = batches(23, 2, 8, 9, 5)
    jnet = _bn_free_net(jlayers, jl2, JaxNetwork, 29)
    net = _bn_free_net(tlayers, tl2, FeedForwardNetwork, 29)
    big = _bn_free_net(tlayers, tl2, FeedForwardNetwork, 29)
    jt, t = _trainers(jnet, net, 0.05)
    jloss = jt.accumulate_step(X, y)
    loss = t.accumulate_step(X, y)
    big_loss, _ = Trainer(big, SGDMomentum(big, 0.05, 0.9), device="cpu").step(
        X.reshape(16, *X.shape[2:]), y.reshape(16, -1))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(big_loss), rtol=1e-5)
    assert_trees_close(net.gather_params(), jnet.gather_params(), "params vs JAX")
    assert_trees_close(net.gather_params(), big.gather_params(), "params vs big batch",
                       rtol=1e-5, atol=1e-6)


def test_accumulate_advances_the_ema_once(monkeypatch):
    """One accumulate_step of K = 3 is one update: the EMA moves once,
    ema = d * p_before + (1 - d) * p_after. On a fresh network the BN
    pre-pass runs a forward only, and the K micro-batches one forward and
    backward each."""
    np.random.seed(31)
    net = narrow_net(tlayers, tl2, FeedForwardNetwork)
    t = Trainer(net, SGDMomentum(net, 0.05, 0.9), ema_decay=0.9, device="cpu")
    calls = {"_train_forward": 0, "_loss_and_grads": 0}
    for name in calls:
        real = getattr(net, name)

        def counted(*args, _real=real, _name=name):
            calls[_name] += 1
            return _real(*args)

        monkeypatch.setattr(net, name, counted)
    before = [p.detach().clone() for p in net.parameters()]
    X, y = batches(32, 3, 4, 17, 10)
    t.accumulate_step(X, y)
    assert calls == {"_train_forward": 1, "_loss_and_grads": 3}
    for e, p0, p1 in zip(t._ema, before, net.parameters(), strict=True):
        torch.testing.assert_close(e, 0.9 * p0 + 0.1 * p1.detach(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="at least one"):
        t.accumulate_step(X[:0], y[:0])
