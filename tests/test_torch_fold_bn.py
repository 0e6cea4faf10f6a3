"""BN folding and ``predict_iter`` of the port's InferenceRunner against the
JAX package (``dorknet_tpu/utils/fold_bn.py``, ``network/inference.py``):
the same trained parameters, folded by each package, give bit-equal folded
weights and the same probs; a folded runner re-folds in place on
``refresh()``; ``predict_iter`` streams the same probs as ``predict_probs``
and as the JAX runner's ``predict_iter``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.layers as jlayers  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.network import InferenceRunner as JaxInferenceRunner  # noqa: E402
from dorknet_tpu.network import Trainer as JaxTrainer  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402
from dorknet_tpu.regularisers.l2 import l2 as jl2  # noqa: E402
from dorknet_tpu.utils.fold_bn import fold_batch_norms as jax_fold  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork, InferenceRunner, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402
from dorknet_tpu_torch.regularisers.l2 import l2 as tl2  # noqa: E402
from dorknet_tpu_torch.utils.fold_bn import fold_batch_norms  # noqa: E402
from tests.test_torch_trainer import batches, narrow_net  # noqa: E402

FOLD_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_utils.py's fold tolerance


def foldme_net(L, network_cls):
    """The JAX fold test's network (tests/test_utils.py): conv without bias
    → BN → ReLU, a residual block of depthwise → BN → pointwise with bias →
    BN, GAP, dense."""
    net = network_cls("foldme")
    net.add_layer(L.ConvLayer("c0", filter_block_shape=(8, 3, 3, 3), with_bias=False))
    net.add_layer(L.BatchNormLayer("bn0", incoming_chans=8))
    net.add_layer(L.ReLu("r0"))
    inner = [
        L.DepthwiseConvLayer("dw", filter_block_shape=(8, 3, 3), with_bias=False),
        L.BatchNormLayer("dw_bn", incoming_chans=8),
        L.PointwiseConvLayer("pw", filter_block_shape=(8, 8), with_bias=True),
        L.BatchNormLayer("pw_bn", incoming_chans=8),
    ]
    net.add_layer(L.ResidualBlock("res", layer_list=inner, skip_projection=None,
                                  post_skip_activation=L.ReLu("res_r")))
    net.add_layer(L.GlobalAveragePoolingLayer("gap"))
    net.add_layer(L.DenseLayer("d", incoming_chans=8, output_dim=4))
    net.set_loss_layer(L.SoftmaxWithCrossEntropy("s"))
    return net


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(which, seed=5, steps=3):
    """The JAX network trained ``steps`` steps by its Trainer (so every BN
    has running stats), and a port network holding the same values."""
    np.random.seed(seed)
    if which == "foldme":
        jnet, hw, classes = foldme_net(jlayers, JaxNetwork), 12, 4
        net = foldme_net(tlayers, FeedForwardNetwork)
    else:
        jnet, hw, classes = narrow_net(jlayers, jl2, JaxNetwork), 17, 10
        net = narrow_net(tlayers, tl2, FeedForwardNetwork)
    X, y = batches(seed, 6, 8, hw, classes)
    jtrainer = JaxTrainer(jnet, JaxSGDMomentum(jnet, 0.05, 0.9))
    for k in range(steps):
        jtrainer.step(X[k], y[k])
    net.load_numpy_params(_numpy(jnet.gather_params()), _numpy(jnet.gather_states()))
    return jnet, net, X, y


def _bn_layers(net):
    return [l for l in net.modules() if isinstance(l, tlayers.BatchNormLayer)]


@pytest.mark.parametrize("which", ["foldme", "narrow"])
def test_folded_weights_are_bit_equal_to_jax(which):
    """Both packages fold in fp32 with the same operations in the same order
    (gamma/std, w*scale, beta + (b - mean)*scale), so the folded trees are
    bit-equal, the biases a fold adds included; the port's source keeps its
    parameters and BNs."""
    jnet, net, _, _ = _pair(which)
    before = [t.detach().clone() for t in list(net.parameters()) + list(net.buffers())]
    want = _numpy(jax_fold(jnet).gather_params())
    folded = fold_batch_norms(net)
    got = folded.gather_params()
    assert (jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want),
                    strict=True):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert folded.name == net.name + "_bnfolded" and not _bn_layers(folded)
    after = list(net.parameters()) + list(net.buffers())
    assert all(torch.equal(a, b) for a, b in zip(after, before, strict=True))
    assert len(_bn_layers(net)) == (3 if which == "foldme" else 8)
    # a conv built without a bias gains a real parameter
    conv = folded.layers[0]
    assert conv.with_bias and isinstance(conv.bias, torch.nn.Parameter)
    assert not net.layers[0].with_bias and "bias" not in dict(net.layers[0].named_parameters())


def test_jax_folded_tree_loads_into_the_port_folded_network():
    """load_numpy_params of the JAX-folded tree into the port-folded network
    changes nothing it serves: the trees are the same, layer for layer."""
    jnet, net, X, _ = _pair("narrow")
    jfolded = jax_fold(jnet)
    folded = fold_batch_norms(net)
    _, want = folded.forward(X[4], test_mode=True)
    folded.load_numpy_params(_numpy(jfolded.gather_params()), _numpy(jfolded.gather_states()))
    _, got = folded.forward(X[4], test_mode=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    _, jprobs = jfolded.forward(X[4], None, test_mode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jprobs), **FOLD_TOL)


@pytest.mark.parametrize("which", ["foldme", "narrow"])
def test_folded_runner_matches_jax_folded_runner(which):
    """The counterpart of tests/test_utils.py's fold test and
    tests/test_network.py's fold_bn runner test: the port's folded runner
    serves the JAX folded runner's probs and the unfolded ones within the
    JAX tolerance; no BN is left in the served copy, at top level or in a
    block; the caller's network keeps its BNs."""
    jnet, net, X, _ = _pair(which)
    Xe = np.concatenate([X[4], X[5][:5]])  # 13 images: one ragged batch
    want = np.asarray(JaxInferenceRunner(jnet, batch_size=8, fold_bn=True).predict_probs(Xe))
    runner = InferenceRunner(net, batch_size=8, device="cpu", fold_bn=True)
    got = runner.predict_probs(Xe)
    assert got.max() > 0.3  # not uniform: the comparison means something
    np.testing.assert_allclose(got, want, **FOLD_TOL)
    plain = InferenceRunner(net, batch_size=8, device="cpu").predict_probs(Xe)
    np.testing.assert_allclose(got, plain, **FOLD_TOL)
    assert not _bn_layers(runner.network) and _bn_layers(net)
    assert len(runner.network.layers) == len(net.layers) - (1 if which == "foldme" else 2)


def test_unfoldable_batch_norms_stay():
    """A BN that follows no conv (here after a ReLU) and one without running
    statistics stay, in both packages, with the same layer lists."""
    def build(L, network_cls):
        net = network_cls("partial")
        net.add_layer(L.ConvLayer("c0", filter_block_shape=(8, 3, 3, 3), with_bias=False))
        net.add_layer(L.ReLu("r0"))
        net.add_layer(L.BatchNormLayer("after_relu", incoming_chans=8))
        net.add_layer(L.DepthwiseConvLayer("dw", filter_block_shape=(8, 3, 3)))
        net.add_layer(L.BatchNormLayer("unset", incoming_chans=8))
        net.add_layer(L.GlobalAveragePoolingLayer("gap"))
        net.add_layer(L.DenseLayer("d", incoming_chans=8, output_dim=4))
        net.set_loss_layer(L.SoftmaxWithCrossEntropy("s"))
        return net

    np.random.seed(9)
    jnet = build(jlayers, JaxNetwork)
    np.random.seed(9)
    net = build(tlayers, FeedForwardNetwork)
    state = {"running_mean": np.full((1, 8, 1, 1), 0.1, np.float32),
             "running_std": np.full((1, 8, 1, 1), 1.5, np.float32)}
    jnet.layers[2].set_state(jax.tree_util.tree_map(jnp.asarray, state))
    net.layers[2].set_state(state)
    names = lambda n: [l.layer_name for l in n.layers]  # noqa: E731
    assert names(fold_batch_norms(net)) == names(jax_fold(jnet)) == names(net)


def test_folded_refresh_refolds_in_place():
    """The counterpart of tests/test_utils.py's fold-refresh test: after
    three more training steps of the source, refresh() of a folded runner
    serves what a folded runner built now serves (and the trained network's
    probs), writing into the tensors it already served; no tensor is
    allocated in their place."""
    _, net, X, y = _pair("narrow", steps=1)
    trainer = Trainer(net, SGDMomentum(net, 0.05, 0.9), device="cpu")
    runner = InferenceRunner(net, batch_size=8, device="cpu", fold_bn=True)
    served = list(runner.network.parameters()) + list(runner.network.buffers())
    ptrs = [t.data_ptr() for t in served]
    before = runner.predict_probs(X[5])
    for k in (1, 2, 3):
        trainer.step(X[k], y[k])
    runner.refresh()
    now = list(runner.network.parameters()) + list(runner.network.buffers())
    assert [t.data_ptr() for t in now] == ptrs
    fresh = InferenceRunner(net, batch_size=8, device="cpu", fold_bn=True)
    for a, b in zip(now, list(fresh.network.parameters()) + list(fresh.network.buffers()),
                    strict=True):
        assert torch.equal(a, b)
    after = runner.predict_probs(X[5])
    assert np.abs(after - before).max() > 1e-3, "training did not move the probs"
    np.testing.assert_array_equal(after, fresh.predict_probs(X[5]))
    np.testing.assert_allclose(after, net.forward(X[5], test_mode=True)[1].numpy(), **FOLD_TOL)


def test_predict_iter_matches_predict_probs_and_jax():
    """The counterpart of tests/test_network.py's predict_iter check: 13
    images in batches of 8 (the second ragged) stream the probs of
    predict_probs and of the JAX runner's predict_iter, and the rest of each
    batch comes through as device_prefetch placed it."""
    jnet, net, X, y = _pair("narrow")
    Xe = np.concatenate([X[4], X[5][:5]])
    ye = np.concatenate([y[4], y[5][:5]])
    labels = ye.argmax(1).astype(np.int32)
    stream = [(Xe[:8], labels[:8], ye[:8]), (Xe[8:], labels[8:], ye[8:])]
    jrunner = JaxInferenceRunner(jnet, batch_size=8)
    runner = InferenceRunner(net, batch_size=8, device="cpu")
    want = list(jrunner.predict_iter(iter(stream)))
    got = list(runner.predict_iter(iter(stream)))
    assert len(got) == len(want) == 2
    for (p, lab, oh), (jp, jlab, joh), (_, blab, boh) in zip(got, want, stream, strict=True):
        assert isinstance(lab, torch.Tensor) and lab.dtype == torch.int32
        assert oh.dtype == torch.float32
        np.testing.assert_array_equal(lab.numpy(), blab)
        np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))
        np.testing.assert_array_equal(oh.numpy(), np.asarray(joh))
        np.testing.assert_allclose(p, np.asarray(jp), rtol=1e-4, atol=1e-6)
    probs = np.concatenate([g[0] for g in got])
    assert probs.shape == (13, 10)
    np.testing.assert_array_equal(probs, runner.predict_probs(Xe))
    folded = InferenceRunner(net, batch_size=8, device="cpu", fold_bn=True)
    np.testing.assert_array_equal(
        np.concatenate([g[0] for g in folded.predict_iter(iter(stream))]),
        folded.predict_probs(Xe))
    assert runner.pinned_rings is None  # the CPU stream pins nothing
    with pytest.raises(ValueError, match="exceeds"):
        next(runner.predict_iter(iter([(np.concatenate([Xe, Xe]),)])))
