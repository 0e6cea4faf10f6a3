"""The serving slice end to end: the port's network, loader, ResNet18 and
InferenceRunner against the reference golden and the JAX package."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from dorknet_tpu.models import ResNet18 as JaxResNet18  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402

from dorknet_tpu_torch.models import ResNet18  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork, InferenceRunner  # noqa: E402
from dorknet_tpu_torch.utils.seeded import seed_serving_weights  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN_DIR = os.path.join(HERE, "goldens", "ref_interop")
GOLDEN_FILES = (os.path.join(GOLDEN_DIR, "ref_structure.json"),
                os.path.join(GOLDEN_DIR, "ref_weights.h5"))


def _numpy_trees(jax_net):
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(jax_net.gather_params()), to_np(jax_net.gather_states())


def _set_jax_trees(jax_net, params, states):
    for layer, p, s in zip(jax_net.layers, params, states, strict=True):
        layer.set_params(jax.tree_util.tree_map(jnp.asarray, p))
        layer.set_state(jax.tree_util.tree_map(jnp.asarray, s))


def test_reference_golden_probs():
    """(a) The reference's own h5+json checkpoint (a depthwise layer, a
    stride-2 pointwise, a skip projection, biases) reproduces its recorded
    test-mode probs (tolerance as tests/test_reference_interop.py)."""
    net = FeedForwardNetwork("interop")
    net.load_network_from_json_and_h5(*GOLDEN_FILES)
    g = np.load(os.path.join(GOLDEN_DIR, "golden.npz"))
    with open(GOLDEN_FILES[0]) as f:
        want_structure = json.load(f)
    for layer in net.layers:
        assert repr(layer) == want_structure[layer.layer_name]
    _, probs = net.forward(g["X"], test_mode=True)
    np.testing.assert_allclose(probs.numpy(), g["test_probs"], rtol=1e-5, atol=1e-6)


def test_jax_trees_carry_across():
    """(b) The same checkpoint loaded into the JAX net, carried across with
    load_numpy_params into a port net whose parameters were zeroed, gives
    the JAX net's probs."""
    g = np.load(os.path.join(GOLDEN_DIR, "golden.npz"))
    jnet = JaxNetwork("interop")
    jnet.load_network_from_json_and_h5(*GOLDEN_FILES)
    _, want = jnet.forward(g["X"], test_mode=True)

    net = FeedForwardNetwork("interop")
    net.load_network_from_json_and_h5(*GOLDEN_FILES)
    with torch.no_grad():
        for p in net.parameters():
            p.zero_()
    net.load_numpy_params(*_numpy_trees(jnet))
    _, got = net.forward(g["X"], test_mode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="layer entries"):
        net.load_numpy_params([], [])


def test_resnet18_seeded_init_is_bit_equal():
    """(c) The same np.random.seed and construction order build bit-equal
    weights and the same structure repr in both packages."""
    np.random.seed(0)
    jnet = JaxResNet18("dogs", num_classes=120)
    np.random.seed(0)
    net = ResNet18("dogs", num_classes=120)
    assert repr(net) == repr(jnet)
    want_tree, got_tree = _numpy_trees(jnet)[0], net.gather_params()
    assert (jax.tree_util.tree_structure(got_tree)
            == jax.tree_util.tree_structure(want_tree))
    for a, b in zip(jax.tree_util.tree_leaves(got_tree),
                    jax.tree_util.tree_leaves(want_tree), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def resnet18_pair():
    """A port ResNet18 with seeded He weights and BN stats, and the JAX
    ResNet18 holding the same values."""
    np.random.seed(0)
    net = ResNet18("dogs", num_classes=120)
    seed_serving_weights(net, seed=0, calib_hw=(33, 33))
    jnet = JaxResNet18("dogs", num_classes=120)
    _set_jax_trees(jnet, net.gather_params(), net.gather_states())
    return net, jnet


def test_resnet18_matches_jax_test_fn(resnet18_pair):
    """(d) Full widths 64→512, all 16 depthwise layers at both strides, at a
    small spatial size: the port's probs equal the JAX _test_fn's
    (fp32, rtol 1e-4 / atol 1e-6 over twenty layers)."""
    net, jnet = resnet18_pair
    X = np.random.RandomState(1).randn(2, 3, 33, 33).astype(np.float32)
    want = np.asarray(jax.jit(jnet._test_fn)(jnet.gather_params(),
                                             jnet.gather_states(), jnp.asarray(X)))
    _, got = net.forward(X, test_mode=True)
    assert got.shape == (2, 120)
    assert want.max() > 0.05  # seeded weights give a peaked, not uniform, answer
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def test_inference_runner_pads_and_slices(resnet18_pair):
    """(e) batch_size 4 over 7 images: two dispatches, the second padded,
    equal to one plain forward of all 7; with fold_bn=True the same probs
    within the JAX fold tolerance (rtol 1e-4, atol 1e-5)."""
    net, _ = resnet18_pair
    X = np.random.RandomState(2).randn(7, 3, 33, 33).astype(np.float32)
    runner = InferenceRunner(net, batch_size=4, device="cpu")
    got = runner.predict_probs(X)
    _, want = net.forward(X, test_mode=True)
    assert got.shape == (7, 120) and got.dtype == np.float32
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(runner.predict(X), got.argmax(1))
    assert runner.predict_probs(X[:0]).shape == (0, 120)
    folded = InferenceRunner(net, batch_size=4, device="cpu", fold_bn=True)
    np.testing.assert_allclose(folded.predict_probs(X), got, rtol=1e-4, atol=1e-5)


def _identity_join_net(layers, network_cls):
    """conv -> ResidualBlock([depthwise with bias, BN], identity skip,
    IdentityLayer join) -> GAP -> dense -> softmax."""
    net = network_cls("idjoin")
    net.add_layer(layers.ConvLayer("c1", filter_block_shape=(8, 3, 3, 3)))
    net.add_layer(layers.ResidualBlock(
        "res", layer_list=[layers.DepthwiseConvLayer("dw", filter_block_shape=(8, 3, 3)),
                           layers.BatchNormLayer("bn", incoming_chans=8)],
        post_skip_activation=layers.IdentityLayer("join")))
    net.add_layer(layers.GlobalAveragePoolingLayer("gap"))
    net.add_layer(layers.DenseLayer("d1", incoming_chans=8, output_dim=5))
    net.set_loss_layer(layers.SoftmaxWithCrossEntropy("loss"))
    return net


def test_identity_join_block_matches_jax():
    """A residual block with an identity skip and an IdentityLayer join (no
    post-skip nonlinearity), and biases everywhere, against the JAX net."""
    import dorknet_tpu.layers as jlayers
    import dorknet_tpu_torch.layers as tlayers

    np.random.seed(3)
    jnet = _identity_join_net(jlayers, JaxNetwork)
    np.random.seed(3)
    net = _identity_join_net(tlayers, FeedForwardNetwork)
    assert repr(net) == repr(jnet)
    seed_serving_weights(net, seed=3, calib_hw=(9, 9))
    _set_jax_trees(jnet, net.gather_params(), net.gather_states())
    X = np.random.RandomState(4).randn(3, 3, 9, 9).astype(np.float32)
    _, want = jnet.forward(X, test_mode=True)
    _, got = net.forward(X, test_mode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_unset_batch_norm_refuses_to_run():
    np.random.seed(0)
    net = ResNet18("dogs", num_classes=10)
    with pytest.raises(ValueError, match="conv0_bn"):
        InferenceRunner(net, batch_size=2)
    with pytest.raises(ValueError, match="running statistics"):
        net.layers[1].fapply(torch.zeros(1, 4, 4, 64))


def test_port_imports_no_jax():
    """(f) The port imports neither jax, cv2 nor dorknet_tpu, and h5py only
    inside the checkpoint loader."""
    code = ("import sys, dorknet_tpu_torch.network, dorknet_tpu_torch.models\n"
            "import dorknet_tpu_torch.network.trainer, dorknet_tpu_torch.optimisers\n"
            "import dorknet_tpu_torch.data_loading, dorknet_tpu_torch.ops.cuda.augment\n"
            "import dorknet_tpu_torch.ops.augment\n"
            "import dorknet_tpu_torch.data_loading.device_dataset\n"
            "import dorknet_tpu_torch.data_loading.prefetch\n"
            "import dorknet_tpu_torch.ops.cuda.bn_stats, dorknet_tpu_torch.ops.cuda.matmul\n"
            "import dorknet_tpu_torch.utils.autotune, dorknet_tpu_torch.utils.bn_fuse_ab\n"
            "import dorknet_tpu_torch.utils.fold_bn, dorknet_tpu_torch.serving_artifact\n"
            "import dorknet_tpu_torch.examples.serving_demo\n"
            "import dorknet_tpu_torch.tools.export_serving\n"
            "import dorknet_tpu_torch.utils.schedules\n"
            "bad = [m for m in ('jax', 'h5py', 'cv2', 'dorknet_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)
