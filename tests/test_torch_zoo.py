"""The first half of the stretch zoo against the JAX package on the CPU:
``ReLu6``, ``MaxPoolLayer``, ``ReshapeLayer``, ``MNISTNet``,
``build_resnet18_plain`` and ``MobileNetV2`` (width 0.5).

The layers: forward and input gradient against the JAX layers (max
pooling on inputs without ties, whose gradient both route to the one
maximum), and their h5 attrs both ways. The models (the JAX
``tests/test_models.py:31-86`` at small sizes): built from one
``np.random.seed`` (bit-equal weights; the two deep ones then take seeded
serving weights, see ``SEEDED``), one ``Trainer.step`` each (loss
rtol 1e-5, parameters and running stats within ``tests/test_torch_trainer.py``'s
tolerance), the test-mode probs after it, and h5+json written by either
package loaded by the other to the same probs (rtol 1e-5, atol 1e-6);
MobileNet-V2's BN fold bit-equal to the JAX fold. Also the golden MaxPool
net of ``tests/test_golden_full_net.py``."""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.layers as jlayers  # noqa: E402
import dorknet_tpu.models as jmodels  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.network import Trainer as JaxTrainer  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402
from dorknet_tpu.regularisers.l2 import l2 as jl2  # noqa: E402
from dorknet_tpu.utils.fold_bn import fold_batch_norms as jax_fold  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
import dorknet_tpu_torch.models as tmodels  # noqa: E402
from dorknet_tpu_torch.layers import BatchNormLayer, DepthwiseConvLayer  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402
from dorknet_tpu_torch.regularisers.l2 import l2 as tl2  # noqa: E402
from dorknet_tpu_torch.utils.fold_bn import fold_batch_norms  # noqa: E402
from dorknet_tpu_torch.utils.seeded import seed_serving_weights  # noqa: E402
from tests.test_torch_trainer import TOL, assert_trees_close  # noqa: E402

PROBS = dict(rtol=1e-5, atol=1e-6)


def _layer_pair(kind, **kw):
    return (getattr(jlayers, kind)("l", **kw), getattr(tlayers, kind)("l", **kw))


def _jax_apply(layer, x):
    return layer.fapply(layer.get_params(), layer.get_state(), x, False)[0]


def _compare_layer(jl, tl, x, tol=dict(rtol=1e-6, atol=1e-7)):
    """Forward and the gradient of sum(y * r) with respect to x."""
    r_shape = np.asarray(_jax_apply(jl, jnp.asarray(x))).shape
    r = np.random.RandomState(1).randn(*r_shape).astype(np.float32)
    want_y = np.asarray(_jax_apply(jl, jnp.asarray(x)))
    want_dx = np.asarray(jax.grad(lambda v: jnp.sum(_jax_apply(jl, v) * r))(jnp.asarray(x)))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    y = tl.fapply(xt)
    (y * torch.from_numpy(r)).sum().backward()
    assert tuple(y.shape) == want_y.shape
    np.testing.assert_allclose(y.detach().numpy(), want_y, **tol)
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, **tol)
    return y


def test_relu6_matches_jax():
    """Values on both sides of 0 and 6, and on them: there the gradient is
    0.5 in both packages (``jnp.clip``'s)."""
    x = np.random.RandomState(0).uniform(-3, 9, (2, 5, 5, 4)).astype(np.float32)
    x.flat[:4] = [0.0, 6.0, 0.0, 6.0]
    y = _compare_layer(*_layer_pair("ReLu6"), x)
    assert float(y.detach().min()) == 0.0 and float(y.detach().max()) == 6.0
    assert repr(tlayers.ReLu6("a")) == repr(jlayers.ReLu6("a")) == "ReLu6(a)"


@pytest.mark.parametrize("stride, hw", [(2, 8), (2, 7), (3, 10), (4, 9)])
def test_max_pool_matches_jax_without_ties(stride, hw):
    """VALID windows of the stride's size (a ragged edge dropped); distinct
    values, so both packages send the gradient to the same maximum."""
    x = np.random.RandomState(stride).permutation(2 * hw * hw * 3).astype(np.float32)
    x = (x / x.size).reshape(2, hw, hw, 3)
    jl, tl = _layer_pair("MaxPoolLayer", stride=stride)
    y = _compare_layer(jl, tl, x)
    assert tuple(y.shape) == (2, hw // stride, hw // stride, 3) and y.is_contiguous()
    assert repr(tl) == repr(jl) == "MaxPoolLayer(stride={})".format(stride)


@pytest.mark.parametrize("new_shape, shape", [((48,), (2, 4, 3, 4)), ((3, 4, 4), (2, 4, 3, 4)),
                                              ((12, 2, 2), (2, 2, 2, 12)), ((4, 8), (2, 8, 4))])
def test_reshape_matches_jax(new_shape, shape):
    """Over the NCHW layout, batch kept; NHWC again when the result is 4-D."""
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jl, tl = _layer_pair("ReshapeLayer", new_shape=new_shape)
    _compare_layer(jl, tl, x)
    assert repr(tl) == repr(jl)


@pytest.mark.parametrize("kind, kw, attr", [("MaxPoolLayer", {"stride": 3}, "stride"),
                                            ("ReshapeLayer", {"new_shape": (4, 2, 6)}, "new_shape"),
                                            ("ReLu6", {}, None)])
def test_layer_h5_both_ways(kind, kw, attr, tmp_path):
    for writer, reader in ((jlayers, tlayers), (tlayers, jlayers)):
        path = str(tmp_path / "{}.h5".format(writer.__name__))
        with h5py.File(path, "w") as f:
            getattr(writer, kind)("l", **kw).save_to_h5(f)
        with h5py.File(path, "r") as f:
            assert f["l/layer_info"].attrs["type"] == kind
            back = getattr(reader, kind)("l")
            back.load_from_h5(f)
        if attr:
            assert getattr(back, attr) == kw[attr]
    with h5py.File(str(tmp_path / "dorknet_tpu.layers.h5"), "r") as fj, \
            h5py.File(str(tmp_path / "dorknet_tpu_torch.layers.h5"), "r") as ft:
        for k, v in fj["l/layer_info"].attrs.items():
            assert type(ft["l/layer_info"].attrs[k]) is type(v)
            np.testing.assert_array_equal(ft["l/layer_info"].attrs[k], v)


def golden_maxpool_net(L, l2, network_cls):
    """tests/test_golden_full_net.py's net: conv, BN, ReLU, depthwise,
    strided pointwise, MaxPool, GAP, dense."""
    net = network_cls("golden")
    net.add_layer(L.ConvLayer("conv", filter_block_shape=(8, 3, 3, 3), stride=1, padding=1,
                              with_bias=True, weight_regulariser=l2(0.01)))
    net.add_layer(L.BatchNormLayer("bn", incoming_chans=8))
    net.add_layer(L.ReLu("relu"))
    net.add_layer(L.DepthwiseConvLayer("dw", filter_block_shape=(8, 3, 3), stride=1,
                                       padding=1, with_bias=False))
    net.add_layer(L.PointwiseConvLayer("pw", filter_block_shape=(12, 8), stride=2,
                                       with_bias=True))
    net.add_layer(L.MaxPoolLayer("mp", None, stride=2))
    net.add_layer(L.GlobalAveragePoolingLayer("gap"))
    net.add_layer(L.DenseLayer("dense", incoming_chans=12, output_dim=5, with_bias=True,
                               weight_regulariser=l2(0.02)))
    net.set_loss_layer(L.SoftmaxWithCrossEntropy("softmax"))
    return net


def _model(kind, pkg):
    """(net, side, classes) of one zoo model, built from np.random.seed(0)."""
    np.random.seed(0)
    if kind == "golden_maxpool":
        L, l2, cls = (jlayers, jl2, JaxNetwork) if pkg == "jax" else (tlayers, tl2,
                                                                       FeedForwardNetwork)
        return golden_maxpool_net(L, l2, cls), 12, 5
    models = jmodels if pkg == "jax" else tmodels
    if kind == "mnist":
        return models.MNISTNet("m"), 28, 10
    if kind == "resnet18_plain":
        return models.build_resnet18_plain("r18p", num_classes=6), 33, 6
    return models.MobileNetV2("mnv2", num_classes=6, width_mult=0.5), 48, 6


def _set_jax_trees(jnet, params, states):
    for layer, p, s in zip(jnet.layers, params, states, strict=True):
        layer.set_params(jax.tree_util.tree_map(jnp.asarray, p))
        layer.set_state(jax.tree_util.tree_map(jnp.asarray, s))


MODELS = ["golden_maxpool", "mnist", "resnet18_plain", "mobilenet_v2"]


# the deep models start from seeded He-normal weights and calibrated
# running stats (utils/seeded.py): on the constructors' 0.01-scale weights
# the deep batch norms see inputs whose mean dwarfs their spread at these
# sizes, and the one-pass variance's rounding (a different sum order in
# each package) moves their gamma gradients by up to 10%
SEEDED = ("resnet18_plain", "mobilenet_v2")


@pytest.fixture(scope="module")
def stepped():
    """Each model in both packages after one SGDMomentum step on the same
    batch, with the step's losses and predictions."""
    out = {}
    for kind in MODELS:
        jnet, side, classes = _model(kind, "jax")
        net, _, _ = _model(kind, "torch")
        assert repr(net) == repr(jnet)
        assert_trees_close(net.gather_params(), jnet.gather_params(), "init",
                           rtol=0, atol=0)
        if kind in SEEDED:
            seed_serving_weights(net, seed=0, calib_hw=(side, side))
            _set_jax_trees(jnet, net.gather_params(), net.gather_states())
        chans = 1 if kind == "mnist" else 3
        rng = np.random.RandomState(2)
        X = rng.randn(4, chans, side, side).astype(np.float32)
        y = np.eye(classes, dtype=np.float32)[rng.randint(0, classes, 4)]
        jloss, jpreds = JaxTrainer(jnet, JaxSGDMomentum(jnet, 0.01, 0.9)).step(X, y)
        trainer = Trainer(net, SGDMomentum(net, 0.01, 0.9), device="cpu")
        loss, preds = trainer.step(X, y)
        out[kind] = (jnet, net, X, float(jloss), float(loss), np.asarray(jpreds), preds)
    return out


@pytest.mark.parametrize("kind", MODELS)
def test_one_step_matches_jax(stepped, kind):
    jnet, net, X, jloss, loss, jpreds, preds = stepped[kind]
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_array_equal(preds.numpy(), jpreds)
    assert_trees_close(net.gather_params(), jnet.gather_params(), "params")
    assert_trees_close(net.gather_states(), jnet.gather_states(), "BN running stats")


@pytest.mark.parametrize("kind", MODELS)
def test_test_mode_probs_match_jax(stepped, kind):
    jnet, net, X, *_ = stepped[kind]
    _, probs = net.forward(X, test_mode=True)
    _, jprobs = jnet.forward(X, test_mode=True)
    np.testing.assert_allclose(probs.numpy().sum(1), 1.0, rtol=1e-5)
    # the two nets differ by one step's rounding: hold the port's own tree,
    # carried into a JAX net, to the same function
    jsame, _, _ = _model(kind, "jax")
    _set_jax_trees(jsame, net.gather_params(), net.gather_states())
    np.testing.assert_allclose(probs.numpy(), np.asarray(jsame.forward(X, test_mode=True)[1]),
                               **PROBS)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)


@pytest.mark.parametrize("kind", MODELS)
def test_h5_json_both_ways(stepped, kind, tmp_path):
    jnet, net, X, *_ = stepped[kind]
    for writer, reader in ((net, JaxNetwork("")), (jnet, FeedForwardNetwork(""))):
        h5f, jsf = str(tmp_path / "w.h5"), str(tmp_path / "s.json")
        writer.save_weights_to_h5(h5f)
        writer.save_layer_structure_to_json(jsf)
        reader.load_network_from_json_and_h5(jsf, h5f)
        assert repr(reader) == repr(writer)
        _, want = writer.forward(X, test_mode=True)
        _, got = reader.forward(X, test_mode=True)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **PROBS)


def test_mobilenet_v2_structure():
    """17 depthwise 3x3 layers (padding 1: the kernel route) and 52 batch
    norms at full width; the linear bottlenecks are ResidualBlocks with no
    skip projection and an IdentityLayer join."""
    net, _, _ = _model("mobilenet_v2", "torch")
    full = tmodels.MobileNetV2("full")
    dws = [m for m in full.modules() if isinstance(m, DepthwiseConvLayer)]
    assert len(dws) == 17 and all(d.padding == 1 and (d.f_rows, d.f_cols) == (3, 3)
                                  for d in dws)
    assert sorted({d.num_filters for d in dws}) == [32, 96, 144, 192, 384, 576, 960]
    assert sum(isinstance(m, BatchNormLayer) for m in full.modules()) == 52
    blocks = [l for l in full.layers if isinstance(l, tlayers.ResidualBlock)]
    assert len(blocks) == 10 and all(
        b.skip_projection is None and isinstance(b.post_skip_activation, tlayers.IdentityLayer)
        for b in blocks)
    assert tmodels.mobilenet_v2._make_divisible(32 * 0.5) == 16


def test_mobilenet_v2_fold_matches_jax(stepped):
    """The BN fold of a stepped MobileNet-V2 bit-equal to the JAX fold, and
    its test-mode probs within 1e-5 of the unfolded net's."""
    jnet, net, X, *_ = stepped["mobilenet_v2"]
    jsame, _, _ = _model("mobilenet_v2", "jax")
    _set_jax_trees(jsame, net.gather_params(), net.gather_states())
    folded = fold_batch_norms(net)
    got = folded.gather_params()
    want = jax.tree_util.tree_map(np.asarray, jax_fold(jsame).gather_params())
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert not [m for m in folded.modules() if isinstance(m, BatchNormLayer)]
    _, unfolded = net.forward(X, test_mode=True)
    _, probs = folded.forward(X, test_mode=True)
    np.testing.assert_allclose(probs.numpy(), unfolded.numpy(), rtol=1e-4, atol=1e-5)
