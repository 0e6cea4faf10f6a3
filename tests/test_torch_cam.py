"""The port's CAM and Grad-CAM (``dorknet_tpu_torch/cam.py``) and its
feature tap (``FeedForwardNetwork.forward(terminal_layer_name=...)``)
against ``dorknet_tpu.cam`` and the JAX network on the CPU, on the two tiny
nets of ``tests/test_examples_integration.py`` and a ResNet-18-depsep at
97 px with seeded serving weights. Parameters and running stats are
carried across with ``load_numpy_params`` / the JAX layers' setters.

Tolerances: scores rtol 1e-5, atol 1e-6 (the test-mode forward's fp32
sums in another order); maps atol 1e-4 (relative to their [0, 1] range,
after min-max normalisation); taps rtol 1e-4, atol 1e-4 (batch statistics of 3 images
through four residual blocks, activations of order one); the resize 2e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.cam as jcam  # noqa: E402
import dorknet_tpu.layers as jlayers  # noqa: E402
from dorknet_tpu.models import ResNet18 as JaxResNet18  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.network import Trainer as JaxTrainer  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
import dorknet_tpu_torch.ops.cuda.depthwise as dw_mod  # noqa: E402
from dorknet_tpu_torch import cam  # noqa: E402
from dorknet_tpu_torch.models import ResNet18  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork  # noqa: E402
from dorknet_tpu_torch.utils.seeded import seed_serving_weights  # noqa: E402

SCORES = dict(rtol=1e-5, atol=1e-6)
MAPS = dict(rtol=0, atol=1e-4)
TAPS = dict(rtol=1e-4, atol=1e-4)


def cam_net(L, network_cls):
    """tests/test_examples_integration.py's CAM net: one conv stage tapped
    at 'res8' before GAP and the dense head."""
    net = network_cls("cam-net")
    net.add_layer(L.ConvLayer("conv1", filter_block_shape=(8, 3, 3, 3), with_bias=False))
    net.add_layer(L.BatchNormLayer("bn1", incoming_chans=8))
    net.add_layer(L.ReLu("res8"))
    net.add_layer(L.GlobalAveragePoolingLayer("gap"))
    net.add_layer(L.DenseLayer("dense1", incoming_chans=8, output_dim=4))
    net.set_loss_layer(L.SoftmaxWithCrossEntropy("softmax"))
    return net


def gradcam_net(L, network_cls):
    """Its Grad-CAM net: taps 'early' (before the second conv) and 'res8'."""
    net = network_cls("gradcam-net")
    net.add_layer(L.ConvLayer("conv1", filter_block_shape=(8, 3, 3, 3), with_bias=False))
    net.add_layer(L.BatchNormLayer("bn1", incoming_chans=8))
    net.add_layer(L.ReLu("early"))
    net.add_layer(L.ConvLayer("conv2", filter_block_shape=(8, 8, 3, 3), with_bias=False))
    net.add_layer(L.BatchNormLayer("bn2", incoming_chans=8))
    net.add_layer(L.ReLu("res8"))
    net.add_layer(L.GlobalAveragePoolingLayer("gap"))
    net.add_layer(L.DenseLayer("dense1", incoming_chans=8, output_dim=4))
    net.set_loss_layer(L.SoftmaxWithCrossEntropy("softmax"))
    return net


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def set_jax_trees(jnet, params, states):
    for layer, p, s in zip(jnet.layers, params, states, strict=True):
        layer.set_params(jax.tree_util.tree_map(jnp.asarray, p))
        layer.set_state(jax.tree_util.tree_map(jnp.asarray, s))


def trained_pair(kind):
    """(JAX net, port net, X). The tiny nets: the JAX net trained three
    steps by its trainer, its parameters and running stats carried into the
    port net. The ResNet-18-depsep (10 classes): the port's seeded serving
    weights and calibrated statistics at 97 px, carried into the JAX net
    (a trained step at this size leaves activations of order 1e6)."""
    rng = np.random.RandomState(1)
    if kind == "resnet18":
        np.random.seed(0)
        jnet = JaxResNet18("dogs", num_classes=10)
        net = ResNet18("dogs", num_classes=10)
        seed_serving_weights(net, seed=0, calib_hw=(97, 97))
        set_jax_trees(jnet, net.gather_params(), net.gather_states())
        return jnet, net, rng.randn(6, 3, 97, 97).astype(np.float32)
    build = {"cam": cam_net, "gradcam": gradcam_net}[kind]
    np.random.seed(0)
    jnet = build(jlayers, JaxNetwork)
    net = build(tlayers, FeedForwardNetwork)
    X = rng.randn(6, 3, 16, 16).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 6)]
    tr = JaxTrainer(jnet, JaxSGDMomentum(jnet, 0.05, 0.9))
    for _ in range(3):
        tr.step(X, y)
    net.load_numpy_params(_numpy(jnet.gather_params()), _numpy(jnet.gather_states()))
    return jnet, net, X


@pytest.fixture(scope="module")
def pairs():
    return {kind: trained_pair(kind) for kind in ("cam", "gradcam", "resnet18")}


def _assert_maps(got, want, what):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0 + 1e-6, what
    np.testing.assert_allclose(got, want, err_msg=what, **MAPS)


CAM_CASES = [("cam", "res8", 32), ("cam", "res8", 7), ("gradcam", "res8", 32),
             ("resnet18", "res8", 97)]


@pytest.mark.parametrize("kind, tap, out_size", CAM_CASES)
def test_cam_matches_jax(pairs, kind, tap, out_size):
    """Single-image and batched CAM, the same scores and maps as the JAX
    package; the second case downsamples the 16 x 16 map to 7 x 7."""
    jnet, net, X = pairs[kind]
    s, c = cam.compute_cam_scores(net, X[:1], top_k=3, terminal_layer_name=tap,
                                  out_size=out_size)
    js, jc = jcam.compute_cam_scores(jnet, X[:1], top_k=3, terminal_layer_name=tap,
                                     out_size=out_size)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **SCORES)
    _assert_maps(c, jc, "single")
    sb, cb = cam.compute_cam_scores_batch(net, X[:4], top_k=3, terminal_layer_name=tap,
                                          out_size=out_size)
    jsb, jcb = jcam.compute_cam_scores_batch(jnet, X[:4], top_k=3, terminal_layer_name=tap,
                                             out_size=out_size)
    np.testing.assert_allclose(sb.numpy(), np.asarray(jsb), **SCORES)
    _assert_maps(cb, jcb, "batch")


GRADCAM_CASES = [("gradcam", "res8"), ("gradcam", "early"), ("cam", "res8"),
                 ("resnet18", "res8"), ("resnet18", "res4")]


@pytest.mark.parametrize("kind, tap", GRADCAM_CASES)
def test_gradcam_matches_jax(pairs, kind, tap):
    jnet, net, X = pairs[kind]
    out_size = 32 if kind != "resnet18" else 97
    sb, cb = cam.compute_gradcam_scores_batch(net, X[:4], top_k=2, terminal_layer_name=tap,
                                              out_size=out_size)
    jsb, jcb = jcam.compute_gradcam_scores_batch(jnet, X[:4], top_k=2,
                                                 terminal_layer_name=tap, out_size=out_size)
    np.testing.assert_allclose(sb.numpy(), np.asarray(jsb), **SCORES)
    _assert_maps(cb, jcb, "batch")
    s, c = cam.compute_gradcam_scores(net, X[:1], top_k=3, terminal_layer_name=tap,
                                      out_size=out_size)
    js, jc = jcam.compute_gradcam_scores(jnet, X[:1], top_k=3, terminal_layer_name=tap,
                                         out_size=out_size)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **SCORES)
    _assert_maps(c, jc, "single")


@pytest.mark.parametrize("kind", ["cam", "resnet18"])
def test_batch_cam_equals_per_image_cam(pairs, kind):
    """Each image's tap normalises by its own statistics (JAX's
    tests/test_examples_integration.py:169-181, same tolerances)."""
    _, net, X = pairs[kind]
    size = 32 if kind == "cam" else 97
    sb, cb = cam.compute_cam_scores_batch(net, X[:4], top_k=3, out_size=size)
    for i in range(4):
        s1, c1 = cam.compute_cam_scores(net, X[i:i + 1], top_k=3, out_size=size)
        np.testing.assert_allclose(sb[i].numpy(), s1.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(cb[i].numpy(), c1.numpy(), rtol=1e-4, atol=1e-4)
    # a train-mode tap over all four at once gives other maps
    _, feats_all = net.forward(X[:4], terminal_layer_name="res8")
    _, feats_one = net.forward(X[:1], terminal_layer_name="res8")
    assert not torch.allclose(feats_all[:1], feats_one, atol=1e-3)


def test_top_k_order_on_tied_scores_and_top_k_over_classes(pairs):
    """argsort(scores)[::-1]: among equal scores the higher class index
    first, as JAX orders them; top_k > num_classes gives num_classes maps.
    Tied classes give tied maps, so the order is pinned on the selection."""
    rng = np.random.RandomState(0)
    for k in (1, 3, 6, 10):
        scores = rng.randint(0, 3, (5, 7)).astype(np.float32) / 4  # many ties
        want = np.asarray(jnp.argsort(jnp.asarray(scores), axis=1)[:, ::-1][:, :k])
        np.testing.assert_array_equal(cam._top_k(torch.from_numpy(scores), k).numpy(), want)
    assert cam._top_k(torch.tensor([[0.1, 0.3, 0.3, 0.3, 0.0]]), 2).tolist() == [[3, 2]]

    jnet, net, X = pairs["cam"]
    s, c = cam.compute_cam_scores(net, X[:1], top_k=6, out_size=32)
    js, jc = jcam.compute_cam_scores(jnet, X[:1], top_k=6, out_size=32)
    assert c.shape == (4, 32, 32)
    _assert_maps(c, jc, "top_k > classes")
    # a zero dense head: every class scores 1/4 in both packages
    params, states = _numpy(jnet.gather_params()), _numpy(jnet.gather_states())
    params[-1] = {k: np.zeros_like(v) for k, v in params[-1].items()}
    jtied = cam_net(jlayers, JaxNetwork)
    set_jax_trees(jtied, params, states)
    tied = cam_net(tlayers, FeedForwardNetwork)
    tied.load_numpy_params(params, states)
    s, c = cam.compute_cam_scores_batch(tied, X[:2], top_k=6, out_size=32)
    js, jc = jcam.compute_cam_scores_batch(jtied, X[:2], top_k=6, out_size=32)
    assert torch.equal(s, torch.full((2, 4), 0.25)) and np.all(np.asarray(js) == 0.25)
    assert c.shape == (2, 4, 32, 32)
    _assert_maps(c, jc, "tied")
    s, c = cam.compute_gradcam_scores_batch(tied, X[:2], top_k=5, out_size=32)
    js, jc = jcam.compute_gradcam_scores_batch(jtied, X[:2], top_k=5, out_size=32)
    assert c.shape == (2, 4, 32, 32)
    _assert_maps(c, jc, "tied Grad-CAM")


def test_return_cam_shim_matches_jax(pairs):
    jnet, net, X = pairs["cam"]
    _, feats = net.forward(X[:1], terminal_layer_name="res8")
    w = net.layers[-1].weights.detach().numpy().T  # (4, 8)
    feats = np.ascontiguousarray(feats.numpy())
    for size in ((32, 32), (225, 225), (8, 12), (5, 5)):
        got = cam.returnCAM(feats, w, [2, 0, 3], size_upsample=size)
        want = jcam.returnCAM(feats, w, [2, 0, 3], size_upsample=size)
        assert len(got) == 3
        for g, h in zip(got, want):
            assert g.shape == size
            np.testing.assert_allclose(g, np.asarray(h), rtol=0, atol=2e-6)


@pytest.mark.parametrize("shape, size", [((3, 7, 7), (225, 225)), ((2, 14, 14), (64, 64)),
                                         ((2, 64, 64), (16, 16)), ((1, 225, 225), (7, 7)),
                                         ((2, 10, 10), (7, 7)), ((1, 5, 9), (12, 4)),
                                         ((1, 13, 13), (13, 13))])
def test_resize_matches_jax_image_resize(shape, size):
    """Up (half-pixel centres) and down (antialiased) against
    jax.image.resize(..., "bilinear")."""
    a = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(a), shape[:1] + size, "bilinear"))
    got = cam._resize(torch.from_numpy(a), size).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_the_errors(pairs):
    _, net, X = pairs["gradcam"]
    fresh = cam_net(tlayers, FeedForwardNetwork)
    for fn in (cam.compute_cam_scores, cam.compute_cam_scores_batch,
               cam.compute_gradcam_scores, cam.compute_gradcam_scores_batch):
        with pytest.raises(ValueError, match="running statistics"):
            fn(fresh, X[:1], terminal_layer_name="res8")
        with pytest.raises(ValueError, match="matches no layer"):
            fn(net, X[:1], terminal_layer_name="nope")
    headless = FeedForwardNetwork("headless")
    for layer in net.layers[:7]:
        headless.add_layer(layer)
    with pytest.raises(ValueError, match="DenseLayer"):
        cam.compute_cam_scores(headless, X[:1], terminal_layer_name="res8")
    with pytest.raises(ValueError, match="matches no layer"):
        net.forward(X[:1], terminal_layer_name="nope")
    with pytest.raises(ValueError, match="matches no layer"):
        net.forward(X[:1], test_mode=True, terminal_layer_name="nope")


def _stats(net):
    return [(name, None if b is None else b.clone()) for name, b in net.named_buffers()]


def test_running_stats_do_not_move(pairs):
    """On a set network every CAM entry point and both taps leave every
    running stat bit-equal; on a fresh one the train-mode tap leaves the
    unset stats unset (the JAX reference's tap would have written them)."""
    _, net, X = pairs["resnet18"]
    before = _stats(net)
    cam.compute_cam_scores(net, X[:1], out_size=16)
    cam.compute_cam_scores_batch(net, X[:3], out_size=16)
    cam.compute_gradcam_scores_batch(net, X[:3], terminal_layer_name="res4", out_size=16)
    net.forward(X[:3], terminal_layer_name="res5")
    net.forward(X[:3], test_mode=True, terminal_layer_name="res5")
    after = _stats(net)
    assert [n for n, _ in after] == [n for n, _ in before] and len(before) == 68
    for (name, a), (_, b) in zip(after, before):
        assert torch.equal(a, b), name
    np.random.seed(0)
    fresh = ResNet18("dogs", num_classes=10)
    _, feats = fresh.forward(X[:2], terminal_layer_name="res2")
    assert feats.shape == (2, 64, 24, 24)
    assert all(not l.bn_initialized() for l in fresh.layers if l.get_state())
    assert all(b is None for _, b in _stats(fresh))


def test_gradcam_computes_no_weight_gradient(pairs, monkeypatch):
    """At the res4 tap the backward runs dx through the 8 later depthwise
    layers once for each of the k maps, and dw never; no parameter gets a
    .grad and every requires_grad is restored."""
    _, net, X = pairs["resnet18"]
    calls = {"dx": 0, "dw": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(dw_mod, "depthwise3x3_dx_plain", counted("dx", dw_mod.depthwise3x3_dx_plain))
    monkeypatch.setattr(dw_mod, "depthwise3x3_dw_plain", counted("dw", dw_mod.depthwise3x3_dw_plain))
    cam.compute_gradcam_scores_batch(net, X[:2], top_k=3, terminal_layer_name="res4",
                                     out_size=16)
    assert calls == {"dx": 8 * 3, "dw": 0}
    cam.compute_gradcam_scores_batch(net, X[:2], top_k=3, terminal_layer_name="res8",
                                     out_size=16)
    assert calls == {"dx": 8 * 3, "dw": 0}
    assert all(p.grad is None and p.requires_grad for p in net.parameters())


@pytest.mark.parametrize("kind, tap", [("gradcam", "early"), ("gradcam", "gap"),
                                       ("resnet18", "res4"), ("resnet18", "pw0_relu"),
                                       ("resnet18", "dense1")])
@pytest.mark.parametrize("test_mode", [False, True])
def test_feature_tap_matches_jax(pairs, kind, tap, test_mode):
    jnet, net, X = pairs[kind]
    zero, got = net.forward(X[:3], test_mode=test_mode, terminal_layer_name=tap)
    jzero, want = jnet.forward(X[:3], test_mode=test_mode, terminal_layer_name=tap)
    assert zero == 0 == jzero
    assert tuple(got.shape) == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TAPS)


def test_test_mode_tap_needs_only_the_prefix_set(pairs):
    """A net whose later batch norm is unset still taps in test mode before
    it, and refuses at or after it."""
    _, net, X = pairs["gradcam"]
    part = gradcam_net(tlayers, FeedForwardNetwork)
    params, states = net.gather_params(), net.gather_states()
    part.load_numpy_params(params)
    part.layers[1].set_state(states[1])
    _, got = part.forward(X[:2], test_mode=True, terminal_layer_name="early")
    _, want = net.forward(X[:2], test_mode=True, terminal_layer_name="early")
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="bn2"):
        part.forward(X[:2], test_mode=True, terminal_layer_name="res8")
