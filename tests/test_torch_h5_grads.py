"""The h5 grads on load: a reference h5 file loaded by the port keeps the
gradients it holds (``<layer>/grads/weights``, ``grads/bias``, batch norm's
``grads/gamma`` and ``grads/beta``), as the JAX loader keeps them
(``dorknet_tpu/utils/h5io.py:load_param_datasets(load_grads=True)``). So
a JAX-written file with non-zero grads, loaded and saved again by the port,
is bit for bit the JAX package's own load and save, and
``update_weights()`` right after a load applies the loaded grads in both.

A file written with ``save_grads=False``: the JAX network loader reads the
grads by default and raises KeyError on it; the port's does the same.
Loaded layer by layer with ``load_grads=False`` it loads in both, to the
same probs, and ``save_grads=False`` writes it back alike. Saving such a
layer with its grads differs: a JAX layer built from a name holds no grads
and raises KeyError, the port's writes zeros, as it does for any layer
before a backward."""

import json

import h5py
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.layers as jlayers  # noqa: E402
from dorknet_tpu.layers.registry import get_layer_class as jget_layer_class  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.optimisers import SGD as JaxSGD  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
from dorknet_tpu_torch.layers.registry import get_layer_class  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork  # noqa: E402
from dorknet_tpu_torch.optimisers import SGD  # noqa: E402
from tests.test_torch_h5_write import _assert_same_file, _nets  # noqa: E402
from tests.test_torch_trainer import batches  # noqa: E402


def _jax_files(kind, tmp_path, save_grads=True):
    """A JAX net after one training forward and backward (non-zero grads in
    every layer), written as h5+json."""
    jnet, _, classes, side = _nets(kind)
    X, y = batches(7, 1, 4, side, classes)
    jnet.forward(X[0], y[0])
    jnet.backward()
    files = (str(tmp_path / "jax.json"), str(tmp_path / "jax.h5"))
    jnet.save_layer_structure_to_json(files[0])
    with h5py.File(files[1], "w") as f:
        for layer in jnet.layers:
            layer.save_to_h5(f, save_grads=save_grads)
        jnet.loss_layer.save_to_h5(f)
    return files, X[0]


@pytest.mark.parametrize("kind", ["narrow", "biased", "resnet18"])
def test_load_and_save_again_is_the_jax_packages(kind, tmp_path):
    files, _ = _jax_files(kind, tmp_path)
    jnet = JaxNetwork("")
    jnet.load_network_from_json_and_h5(*files)
    jnet.save_weights_to_h5(str(tmp_path / "jax_again.h5"))
    net = FeedForwardNetwork("")
    net.load_network_from_json_and_h5(*files)
    net.save_weights_to_h5(str(tmp_path / "port_again.h5"))
    paths = _assert_same_file(str(tmp_path / "port_again.h5"), str(tmp_path / "jax_again.h5"))
    with h5py.File(str(tmp_path / "port_again.h5"), "r") as f:
        grads = [p for p in paths if "/grads/" in p]
        assert grads and all(f[p][()].any() for p in grads)
    # gather_grads gives the loaded trees, in the JAX package's shape
    got = jax.tree_util.tree_leaves(net.gather_grads())
    want = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, [l.get_grads() for l in jnet.layers]))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["narrow", "biased"])
def test_update_weights_applies_the_loaded_grads(kind, tmp_path):
    """One SGD update right after the load: the same parameters in both
    packages (rtol 1e-6, the same fp32 update on the same values)."""
    files, X = _jax_files(kind, tmp_path)
    jnet, net = JaxNetwork(""), FeedForwardNetwork("")
    jnet.load_network_from_json_and_h5(*files)
    net.load_network_from_json_and_h5(*files)
    before = jax.tree_util.tree_leaves(net.gather_params())
    JaxSGD(jnet, 0.1).update_weights()
    SGD(net, 0.1).update_weights()
    got = jax.tree_util.tree_leaves(net.gather_params())
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jnet.gather_params()))
    assert any(not np.array_equal(a, b) for a, b in zip(got, before))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def _load_layers(files, network, get_class):
    """The network loader's walk, every layer loaded with load_grads=False."""
    with open(files[0]) as f:
        structure = json.load(f)
    with h5py.File(files[1], "r") as f:
        network.name = structure.pop("name")
        for name in structure:
            l_type = f[name + "/layer_info"].attrs["type"]
            if l_type == "SoftmaxWithCrossEntropy":
                continue
            layer = get_class(l_type)(name)
            layer.load_from_h5(f, load_grads=False)
            network.add_layer(layer)
    return network


@pytest.mark.parametrize("kind", ["narrow", "biased"])
def test_a_file_without_grads(kind, tmp_path):
    files, X = _jax_files(kind, tmp_path, save_grads=False)
    with h5py.File(files[1], "r") as f:
        assert not any("grads" in p for p in f)
    with pytest.raises(KeyError):
        JaxNetwork("").load_network_from_json_and_h5(*files)
    with pytest.raises(KeyError):
        FeedForwardNetwork("").load_network_from_json_and_h5(*files)
    jnet = _load_layers(files, JaxNetwork(""), jget_layer_class)
    net = _load_layers(files, FeedForwardNetwork(""), get_layer_class)
    with h5py.File(str(tmp_path / "j.h5"), "w") as fj, \
            h5py.File(str(tmp_path / "p.h5"), "w") as fp:
        for jl, tl in zip(jnet.layers, net.layers, strict=True):
            jl.save_to_h5(fj, save_grads=False)
            tl.save_to_h5(fp, save_grads=False)
    with h5py.File(str(tmp_path / "j.h5"), "r") as fj, \
            h5py.File(str(tmp_path / "p.h5"), "r") as fp:
        paths = []
        fj.visit(paths.append)
        assert paths and not any("grads" in p for p in paths)
        for p in paths:
            if isinstance(fj[p], h5py.Dataset) and fj[p].shape:
                np.testing.assert_array_equal(fp[p][()], fj[p][()], err_msg=p)
    with h5py.File(str(tmp_path / "j2.h5"), "w") as f:
        with pytest.raises(KeyError):
            jnet.layers[0].save_to_h5(f)
    with h5py.File(str(tmp_path / "p2.h5"), "w") as f:
        net.layers[0].save_to_h5(f)
        assert not f["conv0/grads/weights" if kind == "narrow" else "c0/grads/weights"][()].any()
    _, got = net.forward(X, test_mode=True)
    _, want = jnet.forward(X, test_mode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_layer_loaders_take_load_grads():
    """Every registered layer's load_from_h5 takes load_grads, as in the
    JAX package."""
    import inspect

    from dorknet_tpu_torch.layers.registry import LAYER_REGISTRY

    assert {"ReLu6", "MaxPoolLayer", "ReshapeLayer"} <= set(LAYER_REGISTRY)
    for name, cls in LAYER_REGISTRY.items():
        sig = inspect.signature(cls.load_from_h5)
        assert sig.parameters["load_grads"].default is True, name
    assert tlayers.ReLu6 is LAYER_REGISTRY["ReLu6"]
