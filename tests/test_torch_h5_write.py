"""The port's h5+json writing against the JAX package on the CPU: the same
parameters, statistics and gradients written by both packages give the same
file (dataset paths, attrs with their types, dtypes, shapes and bit-equal
values, the regulariser attrs as ``np.bytes_``), the same structure json
byte for byte, and files that the other package loads to the same
test-mode probs (within 1e-5). The reference's own interop checkpoint,
rewritten by the port, reproduces its recorded probs (rtol 1e-5, atol
1e-6, as ``tests/test_reference_interop.py``)."""

import json
import os

import h5py
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
from tests.test_torch_trainer import batches, narrow_net  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(HERE, "goldens", "ref_interop")
GOLDEN_FILES = (os.path.join(GOLDEN_DIR, "ref_structure.json"),
                os.path.join(GOLDEN_DIR, "ref_weights.h5"))


def biased_net(L, l2, network_cls):
    """Every layer kind with biases: a biased conv, a biased depthwise and
    strided pointwise inside a residual block with a linear join
    (IdentityLayer) and a skip projection, GAP, a 2-D batch norm and a
    biased dense head."""
    net = network_cls("biased")
    net.add_layer(L.ConvLayer("c0", filter_block_shape=(6, 3, 3, 3), with_bias=True,
                              weight_regulariser=l2(1e-3), weight_initialiser="glorot_uniform"))
    net.add_layer(L.BatchNormLayer("c0_bn", incoming_chans=6))
    net.add_layer(L.ReLu("c0_relu"))
    block = [L.DepthwiseConvLayer("b_dw", filter_block_shape=(6, 3, 3), stride=2,
                                  with_bias=True),
             L.BatchNormLayer("b_dw_bn", incoming_chans=6),
             L.PointwiseConvLayer("b_pw", filter_block_shape=(8, 6), with_bias=True,
                                  weight_regulariser=l2(1e-3))]
    net.add_layer(L.ResidualBlock(
        "b", layer_list=block,
        skip_projection=L.PointwiseConvLayer("b_skip", filter_block_shape=(8, 6), stride=2,
                                             with_bias=True),
        post_skip_activation=L.IdentityLayer("b_join")))
    net.add_layer(L.GlobalAveragePoolingLayer("gap"))
    net.add_layer(L.BatchNormLayer("gap_bn", input_dimension=2, incoming_chans=8))
    net.add_layer(L.DenseLayer("dense", incoming_chans=8, output_dim=5, with_bias=True,
                               weight_regulariser=l2(1e-3)))
    net.set_loss_layer(L.SoftmaxWithCrossEntropy("loss"))
    return net


def _nets(kind):
    """(JAX net, port net, classes, side): built from one np.random.seed,
    so their weights start bit-equal."""
    if kind == "resnet18":
        np.random.seed(0)
        jnet = JaxResNet18("dogs", num_classes=120)
        np.random.seed(0)
        return jnet, ResNet18("dogs", num_classes=120), 120, 33
    build = {"narrow": narrow_net, "biased": biased_net}[kind]
    np.random.seed(3)
    jnet = build(jlayers, jl2, JaxNetwork)
    np.random.seed(3)
    net = build(tlayers, tl2, FeedForwardNetwork)
    return jnet, net, (10 if kind == "narrow" else 5), 12


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same_state(kind, grads):
    """The two nets holding the same parameters, running stats and
    gradients: the JAX net trained one step, then one training forward and
    (for grads="backward") a backward, and its trees carried across."""
    jnet, net, classes, side = _nets(kind)
    X, y = batches(5, 2, 4, side, classes)
    JaxTrainer(jnet, JaxSGDMomentum(jnet, 0.01, 0.9)).step(X[0], y[0])
    if grads == "backward":
        jnet.forward(X[1], y[1])
        jnet.backward()
    net.load_numpy_params(_numpy(jnet.gather_params()), _numpy(jnet.gather_states()))
    if grads == "backward":
        for layer, jlayer in zip(net.layers, jnet.layers, strict=True):
            g = _numpy(jlayer.get_grads())
            layer.set_grads(jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), g))
    return jnet, net


def _walk(f):
    out = []
    f.visit(out.append)
    return out


def _assert_same_file(got_path, want_path):
    with h5py.File(got_path, "r") as got, h5py.File(want_path, "r") as want:
        paths = _walk(want)
        assert _walk(got) == paths
        n_grads = 0
        for p in paths:
            a, b = got[p], want[p]
            assert type(a) is type(b), p
            assert dict(a.attrs).keys() == dict(b.attrs).keys(), p
            for k, v in b.attrs.items():
                assert type(a.attrs[k]) is type(v), (p, k)
                np.testing.assert_array_equal(a.attrs[k], v, err_msg="{} attr {}".format(p, k))
            if isinstance(b, h5py.Dataset):
                assert a.dtype == b.dtype and a.shape == b.shape, p
                if b.shape is not None:  # the scalar layer_info datasets
                    np.testing.assert_array_equal(a[()], b[()], err_msg=p)
                n_grads += "/grads/" in p
        assert n_grads > 0
    return paths


@pytest.mark.parametrize("kind, grads", [("narrow", "zeros"), ("narrow", "backward"),
                                         ("biased", "zeros"), ("biased", "backward"),
                                         ("resnet18", "backward")])
def test_same_state_writes_the_same_file(kind, grads, tmp_path):
    jnet, net = _same_state(kind, grads)
    jnet.save_weights_to_h5(str(tmp_path / "jax.h5"))
    net.save_weights_to_h5(str(tmp_path / "port.h5"))
    paths = _assert_same_file(str(tmp_path / "port.h5"), str(tmp_path / "jax.h5"))
    with h5py.File(str(tmp_path / "port.h5"), "r") as f:
        regs = [p for p in paths if "weight_regulariser_type" in f[p].attrs]
        assert regs and all(isinstance(f[p].attrs["weight_regulariser_strength"], np.bytes_)
                            for p in regs)
        if grads == "zeros":
            assert all(not f[p][()].any() for p in paths if "/grads/" in p)
    jnet.save_layer_structure_to_json(str(tmp_path / "jax.json"))
    net.save_layer_structure_to_json(str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


@pytest.mark.parametrize("kind", ["narrow", "biased"])
def test_jax_loads_what_the_port_wrote(kind, tmp_path):
    """A port net trained two steps by its own trainer, then a reference
    forward/backward (so the grads are its own), written as h5+json and
    loaded by the JAX package: the same test-mode probs."""
    _, net, classes, side = _nets(kind)
    X, y = batches(6, 3, 4, side, classes)
    trainer = Trainer(net, SGDMomentum(net, 0.01, 0.9), device="cpu")
    for k in range(2):
        trainer.step(X[k], y[k])
    net.forward(X[2], y[2])
    net.backward()
    net.save_weights_to_h5(str(tmp_path / "w.h5"))
    net.save_layer_structure_to_json(str(tmp_path / "s.json"))
    jnet = JaxNetwork("")
    jnet.load_network_from_json_and_h5(str(tmp_path / "s.json"), str(tmp_path / "w.h5"))
    assert repr(jnet) == repr(net)
    _, want = net.forward(X[2], test_mode=True)
    _, got = jnet.forward(X[2], test_mode=True)
    np.testing.assert_allclose(np.asarray(got), want.numpy(), rtol=1e-5, atol=1e-6)
    # and the port reads its own file back to the same probs, bit for bit
    back = FeedForwardNetwork("")
    back.load_network_from_json_and_h5(str(tmp_path / "s.json"), str(tmp_path / "w.h5"))
    np.testing.assert_array_equal(back.forward(X[2], test_mode=True)[1].numpy(), want.numpy())


def test_reference_golden_rewritten_by_the_port(tmp_path):
    """The reference's interop net, loaded and written again by the port,
    reproduces the reference's recorded test-mode probs through either
    package's loader."""
    g = np.load(os.path.join(GOLDEN_DIR, "golden.npz"))
    net = FeedForwardNetwork("")
    net.load_network_from_json_and_h5(*GOLDEN_FILES)
    files = (str(tmp_path / "s.json"), str(tmp_path / "w.h5"))
    net.save_layer_structure_to_json(files[0])
    net.save_weights_to_h5(files[1])
    with open(GOLDEN_FILES[0]) as f, open(files[0]) as f2:
        assert json.load(f2) == json.load(f)
    for reader in (FeedForwardNetwork(""), JaxNetwork("")):
        reader.load_network_from_json_and_h5(*files)
        _, probs = reader.forward(g["X"], test_mode=True)
        np.testing.assert_allclose(np.asarray(probs), g["test_probs"], rtol=1e-5, atol=1e-6)


def test_unset_batch_norm_refuses_to_save(tmp_path):
    _, net, _, _ = _nets("narrow")
    with pytest.raises(ValueError, match="no running statistics"):
        net.save_weights_to_h5(str(tmp_path / "w.h5"))
