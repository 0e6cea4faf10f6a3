"""The training slice against the JAX package on the CPU: ``Trainer.step``
(SGDMomentum, global-norm clip, EMA) from the same fresh weights in both
packages, on a narrow depthwise-separable net and on ResNet18 at full width,
and the reference loop forward/backward/update_weights against
``Trainer.step`` within the port.

Tolerances (fp32 on both sides, sums in different orders): loss rtol 1e-5;
parameters, batch-norm running stats and EMA parameters rtol 1e-4 / atol
1e-5."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.layers as jlayers  # noqa: E402
from dorknet_tpu.models import ResNet18 as JaxResNet18  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.network import Trainer as JaxTrainer  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402
from dorknet_tpu.regularisers.l2 import l2 as jl2  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
from dorknet_tpu_torch.models import ResNet18  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402
from dorknet_tpu_torch.regularisers.l2 import l2 as tl2  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


def narrow_net(L, l2, network_cls):
    """Stem conv, BN, ReLU, strided pointwise, two residual blocks (the
    second downsamples through a stride-2 depthwise and a skip projection),
    GAP, dense; l2 on every conv, pointwise and dense weight."""
    net = network_cls("narrow")
    net.add_layer(L.ConvLayer("conv0", filter_block_shape=(8, 3, 3, 3), stride=2,
                              padding=1, with_bias=False, weight_regulariser=l2(1e-3)))
    net.add_layer(L.BatchNormLayer("conv0_bn", incoming_chans=8))
    net.add_layer(L.ReLu("conv0_relu"))
    net.add_layer(L.PointwiseConvLayer("pw0", filter_block_shape=(8, 8), stride=2,
                                       with_bias=False, weight_regulariser=l2(1e-3)))
    net.add_layer(L.BatchNormLayer("pw0_bn", incoming_chans=8))
    net.add_layer(L.ReLu("pw0_relu"))

    def block(name, cin, cout, down):
        layer_list = [
            L.DepthwiseConvLayer(name + "_dw1", filter_block_shape=(cin, 3, 3),
                                 stride=2 if down else 1, with_bias=False),
            L.BatchNormLayer(name + "_dw1_bn", incoming_chans=cin),
            L.PointwiseConvLayer(name + "_pw1", filter_block_shape=(cout, cin),
                                 with_bias=False, weight_regulariser=l2(1e-3)),
            L.BatchNormLayer(name + "_pw1_bn", incoming_chans=cout),
            L.ReLu(name + "_relu1"),
            L.DepthwiseConvLayer(name + "_dw2", filter_block_shape=(cout, 3, 3)),
            L.BatchNormLayer(name + "_dw2_bn", incoming_chans=cout),
        ]
        skip = None
        if down:
            skip = L.PointwiseConvLayer(name + "_skip", filter_block_shape=(cout, cin),
                                        stride=2, with_bias=False,
                                        weight_regulariser=l2(1e-3))
        return L.ResidualBlock(name, layer_list=layer_list, skip_projection=skip,
                               post_skip_activation=L.ReLu(name + "_relu2"))

    net.add_layer(block("res1", 8, 8, False))
    net.add_layer(block("res2", 8, 16, True))
    net.add_layer(L.GlobalAveragePoolingLayer("gap"))
    net.add_layer(L.DenseLayer("dense", incoming_chans=16, output_dim=10,
                               weight_regulariser=l2(1e-3)))
    net.set_loss_layer(L.SoftmaxWithCrossEntropy("loss"))
    return net


def batches(seed, steps, B, hw, classes):
    rng = np.random.RandomState(seed)
    X = rng.randn(steps, B, 3, hw, hw).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.randint(0, classes, (steps, B))]
    return X, y


def assert_trees_close(got, want, what, **tol):
    got_leaves = jax.tree_util.tree_leaves(got)
    want_leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, want))
    assert len(got_leaves) == len(want_leaves) > 0, what
    for i, (a, b) in enumerate(zip(got_leaves, want_leaves, strict=True)):
        assert a.shape == b.shape, (what, i)
        np.testing.assert_allclose(a, b, err_msg="{} leaf {}".format(what, i),
                                   **(tol or TOL))


def run_pair(jnet, net, X, y, lr, ema_decay=0.9, clip_norm=1.0):
    """Train both networks step by step and compare after every step."""
    jtrainer = JaxTrainer(jnet, JaxSGDMomentum(jnet, lr, 0.9), ema_decay=ema_decay,
                          clip_norm=clip_norm)
    trainer = Trainer(net, SGDMomentum(net, lr, 0.9), ema_decay=ema_decay,
                      clip_norm=clip_norm, device="cpu")
    for k in range(len(X)):
        jloss, jpreds = jtrainer.step(X[k], y[k])
        loss, preds = trainer.step(X[k], y[k])
        assert loss.shape == () and preds.shape == (X.shape[1],)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   err_msg="loss, step {}".format(k))
        np.testing.assert_array_equal(preds.numpy(), np.asarray(jpreds))
        assert_trees_close(net.gather_params(), jnet.gather_params(),
                           "params, step {}".format(k))
        assert_trees_close(net.gather_states(), jnet.gather_states(),
                           "BN running stats, step {}".format(k))
        if ema_decay is not None:
            assert_trees_close(trainer.ema_params(), jtrainer.ema_params(),
                               "EMA params, step {}".format(k))
    return trainer


def test_narrow_net_three_steps_match_jax():
    """Fresh BN (first step adopts, then the EMA), l2 on, clip 1.0, EMA 0.9,
    three steps of batch 4 at 17x17."""
    np.random.seed(5)
    jnet = narrow_net(jlayers, jl2, JaxNetwork)
    np.random.seed(5)
    net = narrow_net(tlayers, tl2, FeedForwardNetwork)
    assert repr(net) == repr(jnet)
    X, y = batches(6, 3, 4, 17, 10)
    run_pair(jnet, net, X, y, lr=0.05)


def test_narrow_net_clip_binds_and_matches_jax():
    """A clip far below the gradient norm, so every step is rescaled."""
    np.random.seed(7)
    jnet = narrow_net(jlayers, jl2, JaxNetwork)
    np.random.seed(7)
    net = narrow_net(tlayers, tl2, FeedForwardNetwork)
    X, y = batches(8, 2, 4, 17, 10)
    run_pair(jnet, net, X, y, lr=0.5, ema_decay=None, clip_norm=1e-3)


def test_resnet18_two_steps_match_jax():
    """Full widths 64-512, all 16 depthwise layers at both strides (stride 2
    at even H 12->6 and 6->3, at odd H 3->2), batch 2, the flagship's
    SGDMomentum(0.9) with clip 1.0 and EMA 0.9. 49x49 images, not 33x33: at
    33 px the last stage is 1x1, so its batch norms see two samples each,
    and the one-pass E[x²]-E[x]² variance of two nearly equal values is
    ill-conditioned (the two packages' step-0 losses differ by 4.4e-4
    relative there, from rounding alone); at 49 px they see eight."""
    np.random.seed(0)
    jnet = JaxResNet18("dogs", num_classes=120)
    np.random.seed(0)
    net = ResNet18("dogs", num_classes=120)
    X, y = batches(1, 2, 2, 49, 120)
    run_pair(jnet, net, X, y, lr=0.05 * (2 / 200))


def test_fresh_jax_network_carries_across_unset():
    """load_numpy_params(params) with no states leaves a fresh network's BN
    unset, so its first train step adopts the batch statistics, as the JAX
    network's does. (Carrying the JAX package's zeros placeholders across
    would mark BN initialised with zero statistics, and the first step would
    take the EMA of them instead.)"""
    np.random.seed(9)
    jnet = narrow_net(jlayers, jl2, JaxNetwork)
    np.random.seed(10)  # other weights: the carry overwrites them
    net = narrow_net(tlayers, tl2, FeedForwardNetwork)
    net.load_numpy_params(jax.tree_util.tree_map(np.asarray, jnet.gather_params()))
    conv0_bn, res1 = net.layers[1], net.layers[6]
    assert not conv0_bn.bn_initialized() and not res1.bn_initialized()
    X, y = batches(11, 1, 4, 17, 10)
    jloss, _ = jnet.forward(X[0], y[0])
    loss, _ = net.forward(X[0], y[0])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert conv0_bn.bn_initialized() and res1.bn_initialized()
    stem = torch.nn.functional.conv2d(torch.from_numpy(X[0]), net.layers[0].weights.detach(),
                                      stride=2, padding=1)
    np.testing.assert_allclose(conv0_bn.running_mean.reshape(-1).numpy(),
                               stem.mean(dim=(0, 2, 3)).numpy(), rtol=1e-4, atol=1e-6)
    assert_trees_close(net.gather_states(), jnet.gather_states(), "BN running stats")


def test_reference_loop_equals_trainer_step():
    """network.forward(X, y) -> network.backward() -> update_weights()
    gives the parameters and running stats Trainer.step gives, step after
    step (the same operations in the same order: bit-equal)."""
    np.random.seed(3)
    net_a = narrow_net(tlayers, tl2, FeedForwardNetwork)
    np.random.seed(3)
    net_b = narrow_net(tlayers, tl2, FeedForwardNetwork)
    sgd_a = SGDMomentum(net_a, 0.05, 0.9)
    trainer = Trainer(net_b, SGDMomentum(net_b, 0.05, 0.9), device="cpu")
    X, y = batches(4, 3, 4, 17, 10)
    for k in range(3):
        loss_a, probs_a = net_a.forward(X[k], y[k])
        net_a.backward()
        sgd_a.update_weights()
        loss_b, preds_b = trainer.step(X[k], y[k])
        assert float(loss_a) == float(loss_b)
        np.testing.assert_array_equal(probs_a.argmax(1).numpy(), preds_b.numpy())
        for a, b in zip(jax.tree_util.tree_leaves(net_a.gather_params()),
                        jax.tree_util.tree_leaves(net_b.gather_params()), strict=True):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree_util.tree_leaves(net_a.gather_states()),
                        jax.tree_util.tree_leaves(net_b.gather_states()), strict=True):
            np.testing.assert_array_equal(a, b)


def test_reference_loop_grads_match_jax():
    """network.backward() hands every layer, nested ones included, the
    gradients the JAX network's backward() hands it."""
    np.random.seed(12)
    jnet = narrow_net(jlayers, jl2, JaxNetwork)
    np.random.seed(12)
    net = narrow_net(tlayers, tl2, FeedForwardNetwork)
    X, y = batches(13, 1, 4, 17, 10)
    jnet.forward(X[0], y[0])
    jnet.backward()
    net.forward(X[0], y[0])
    net.backward()
    assert_trees_close(net.gather_grads(), [l.get_grads() for l in jnet.layers], "grads")
    with pytest.raises(RuntimeError, match="before a training-mode forward"):
        net.backward()


def test_multi_step_equals_steps():
    np.random.seed(2)
    net_a = narrow_net(tlayers, tl2, FeedForwardNetwork)
    np.random.seed(2)
    net_b = narrow_net(tlayers, tl2, FeedForwardNetwork)
    ta = Trainer(net_a, SGDMomentum(net_a, 0.05, 0.9), device="cpu")
    tb = Trainer(net_b, SGDMomentum(net_b, 0.05, 0.9), device="cpu")
    X, y = batches(3, 3, 4, 17, 10)
    losses, preds = ta.multi_step(X, y)
    assert losses.shape == (3,) and preds.shape == (3, 4)
    for k in range(3):
        loss, p = tb.step(X[k], y[k])
        assert float(loss) == float(losses[k])
        np.testing.assert_array_equal(p.numpy(), preds[k].numpy())


def test_nhwc_input_layout_and_ema_network():
    np.random.seed(4)
    net_a = narrow_net(tlayers, tl2, FeedForwardNetwork)
    np.random.seed(4)
    net_b = narrow_net(tlayers, tl2, FeedForwardNetwork)
    ta = Trainer(net_a, SGDMomentum(net_a, 0.05, 0.9), device="cpu", ema_decay=0.5)
    tb = Trainer(net_b, SGDMomentum(net_b, 0.05, 0.9), device="cpu",
                 input_layout="NHWC", ema_decay=0.5)
    X, y = batches(5, 1, 4, 17, 10)
    assert ta.ema_params() is None
    la, _ = ta.step(X[0], y[0])
    lb, _ = tb.step(np.ascontiguousarray(X[0].transpose(0, 2, 3, 1)), y[0])
    assert float(la) == float(lb)
    ema_net = ta.ema_network()
    for e, p0, p1 in zip(ema_net.parameters(), net_b.parameters(), net_a.parameters()):
        assert not torch.equal(e, p1) or torch.equal(p0, p1)
    _, probs = ema_net.forward(X[0], test_mode=True)
    assert probs.shape == (4, 10) and torch.isfinite(probs).all()
    with pytest.raises(ValueError, match="input_layout"):
        Trainer(net_a, SGDMomentum(net_a, 0.05, 0.9), device="cpu", input_layout="CHW")
    with pytest.raises(ValueError, match="clip_norm"):
        Trainer(net_a, SGDMomentum(net_a, 0.05, 0.9), device="cpu", clip_norm=0.0)


def test_entry_points_default_to_the_card(monkeypatch):
    """Trainer and InferenceRunner run on the card unless asked for the
    CPU: without one they raise at construction."""
    from dorknet_tpu_torch.network import InferenceRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.random.seed(1)
    net = narrow_net(tlayers, tl2, FeedForwardNetwork)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(net, SGDMomentum(net, 0.05, 0.9))
    X, y = batches(1, 1, 2, 17, 10)
    Trainer(net, SGDMomentum(net, 0.05, 0.9), device="cpu").step(X[0], y[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceRunner(net, batch_size=2)
    assert InferenceRunner(net, batch_size=2, device="cpu").predict(X[0]).shape == (2,)
