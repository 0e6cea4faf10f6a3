"""EfficientNet-Lite and ResNet-50/101 against the JAX package on the CPU.

``EfficientNetLite0`` and ``ResNet50`` at full width (64 px, 6 classes),
from seeded serving weights (``utils/seeded.py``) carried across: one
SGDMomentum ``Trainer.step`` against the JAX trainer (the loss rtol 1e-5;
running stats and the classifier within ``tests/test_torch_trainer.py``'s
tolerance; the deeper parameters as one update, see
``test_one_step_matches_jax``), the test-mode probs (rtol 1e-5, atol 1e-6)
and h5+json written by either package loaded by the other. The lite rules
(``tests/test_models.py:136-156``: 16 and 30 blocks, stem and head
unscaled) and the layer counts at 1,000 classes. ``ResNet101``: its 23
third-stage blocks and a test-mode forward on a JAX tree carried across
(no training step, which would cost the JAX compile most of this file's
time)."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.models as jmodels  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.network import Trainer as JaxTrainer  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402

import dorknet_tpu_torch.models as tmodels  # noqa: E402
from dorknet_tpu_torch.layers import (BatchNormLayer, ConvLayer, DepthwiseConvLayer,  # noqa: E402
                                      MaxPoolLayer, PointwiseConvLayer, ResidualBlock)
from dorknet_tpu_torch.network import FeedForwardNetwork, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402
from dorknet_tpu_torch.utils.seeded import seed_serving_weights  # noqa: E402
from tests.test_torch_trainer import TOL, assert_trees_close  # noqa: E402
from tests.test_torch_zoo import PROBS, _set_jax_trees  # noqa: E402

SIDE, CLASSES = 64, 6
MODELS = ["EfficientNetLite0", "ResNet50"]


def _model(kind, pkg, **kw):
    np.random.seed(0)
    models = jmodels if pkg == "jax" else tmodels
    return getattr(models, kind)(kind.lower(), **dict(dict(num_classes=CLASSES), **kw))


def _step(net, X, y):
    return Trainer(net, SGDMomentum(net, 0.01, 0.9), device="cpu").step(X, y)


@pytest.fixture(scope="module")
def stepped():
    """Each model in both packages after one SGDMomentum step on the same
    batch, from seeded serving weights carried across; and the port's step
    again with its input nudged elementwise by 1e-6 relative noise."""
    out = {}
    for kind in MODELS:
        jnet, net = _model(kind, "jax"), _model(kind, "torch")
        assert repr(net) == repr(jnet)
        assert_trees_close(net.gather_params(), jnet.gather_params(), "init", rtol=0, atol=0)
        seed_serving_weights(net, seed=0, calib_hw=(SIDE, SIDE))
        start = net.gather_params()
        _set_jax_trees(jnet, start, net.gather_states())
        nudged = _model(kind, "torch")
        nudged.load_numpy_params(start, net.gather_states())
        rng = np.random.RandomState(2)
        X = rng.randn(4, 3, SIDE, SIDE).astype(np.float32)
        y = np.eye(CLASSES, dtype=np.float32)[rng.randint(0, CLASSES, 4)]
        jloss, jpreds = JaxTrainer(jnet, JaxSGDMomentum(jnet, 0.01, 0.9)).step(X, y)
        loss, preds = _step(net, X, y)
        noise = np.random.RandomState(9).randn(*X.shape).astype(np.float32)
        _step(nudged, X * (1 + 1e-6 * noise), y)
        out[kind] = (jnet, net, X, float(jloss), float(loss), np.asarray(jpreds), preds,
                     start, nudged)
    return out


def _leaves(tree):
    return [np.asarray(a, np.float64) for a in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, tree))]


def _update_rel_l2(got, want, start):
    """The relative L2 difference of two updates from ``start``, over all
    parameters."""
    got, want, start = _leaves(got), _leaves(want), _leaves(start)
    diff = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want, strict=True))
    norm = sum(float(((b - s) ** 2).sum()) for b, s in zip(want, start, strict=True))
    return (diff / norm) ** 0.5


# the chip_smoke.py yardstick of a deep step's update (MNV2_UPDATE_TOL)
UPDATE_TOL = 5e-2


@pytest.mark.parametrize("kind", MODELS)
def test_one_step_matches_jax(stepped, kind):
    """The loss (rtol 1e-5), the predictions, the running stats and the
    classifier's parameters (``TOL``) against the JAX trainer. The other
    parameters are held as one update: these steps are ill-conditioned in
    fp32, so 1e-6 relative noise on the input moves the port's own update
    about as far as it lies from the JAX step, and no per-element limit
    holds for the deep layers. The update's relative L2 difference from
    the JAX step must stay within ``UPDATE_TOL`` and within twice what the
    nudge moves it (both printed)."""
    jnet, net, X, jloss, loss, jpreds, preds, start, nudged = stepped[kind]
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_array_equal(preds.numpy(), jpreds)
    assert_trees_close(net.gather_states(), jnet.gather_states(), "BN running stats")
    assert_trees_close(net.gather_params()[-1], jnet.gather_params()[-1], "classifier")
    rel = _update_rel_l2(net.gather_params(), jnet.gather_params(), start)
    noise = _update_rel_l2(nudged.gather_params(), net.gather_params(), start)
    print("{}: the update's relative L2 difference from the JAX step {:.3e}, moved by "
          "the nudge {:.3e}".format(kind, rel, noise))
    assert rel <= UPDATE_TOL and rel <= 2 * noise, (rel, noise)


@pytest.mark.parametrize("kind", MODELS)
def test_test_mode_probs_match_jax(stepped, kind):
    """The port's stepped tree carried into a JAX net gives the same probs
    (rtol 1e-5, atol 1e-6). The two packages' own stepped nets differ by
    their steps' updates, so their probs are held as the update is: within
    the tolerance, or within twice what the nudged step moves them."""
    jnet, net, X, *_, nudged = stepped[kind]
    _, probs = net.forward(X, test_mode=True)
    np.testing.assert_allclose(probs.numpy().sum(1), 1.0, rtol=1e-5)
    jsame = _model(kind, "jax")
    _set_jax_trees(jsame, net.gather_params(), net.gather_states())
    np.testing.assert_allclose(probs.numpy(), np.asarray(jsame.forward(X, test_mode=True)[1]),
                               **PROBS)
    err = np.abs(probs.numpy() - np.asarray(jnet.forward(X, test_mode=True)[1])).max()
    noise = np.abs(probs.numpy() - nudged.forward(X, test_mode=True)[1].numpy()).max()
    assert err <= max(TOL["atol"], 2 * noise), (err, noise)


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


def _blocks(net):
    return len({l.layer_name.split("_")[0] for l in net.layers if l.layer_name.startswith("mb")})


def _by_name(net, name):
    return next(l for l in net.layers if l.layer_name == name)


def test_efficientnet_lite_rules():
    """``tests/test_models.py:136-156``: width scales the interior stages
    only (stem 32 and head 1,280 channels at width 1.4), and depth exempts
    the first and last stages (16 blocks at depth 1, 1 + 2 * 14 + 1 = 30
    at depth 2, with math.ceil); each equal to the JAX builder's repr."""
    wide = tmodels.EfficientNetLite("enl-w", num_classes=3, width_mult=1.4)
    deep = tmodels.EfficientNetLite("enl-d", num_classes=3, depth_mult=2.0)
    assert _by_name(wide, "stem").weights.shape[0] == 32
    assert _by_name(wide, "head").weights.shape[0] == 1280
    assert _blocks(wide) == 16 and _blocks(deep) == 30
    assert _blocks(tmodels.EfficientNetLite("enl-c", num_classes=3, depth_mult=1.1)) == 21
    for kw in (dict(width_mult=1.4), dict(depth_mult=2.0), dict(width_mult=1.1, depth_mult=1.2)):
        np.random.seed(0)
        want = repr(jmodels.EfficientNetLite("enl", num_classes=3, **kw))
        np.random.seed(0)
        assert repr(tmodels.EfficientNetLite("enl", num_classes=3, **kw)) == want


# (3x3 depthwise (C, stride), 5x5 depthwise, batch norms, parameters) at
# 1,000 classes, as the JAX builders give them
FULL_WIDTH = {
    "EfficientNetLite0": ([(32, 1), (96, 2), (144, 1), (240, 2), (480, 1), (480, 1),
                           (1152, 1)], 9, 49, 4652008),
    "ResNet50": ([], 0, 49, 25549352),
}


@pytest.mark.parametrize("kind", MODELS)
def test_full_width_structure(kind):
    net = _model(kind, "torch", num_classes=1000)
    dws = [m for m in net.modules() if isinstance(m, DepthwiseConvLayer)]
    three, five, bns, params = FULL_WIDTH[kind]
    assert [(d.num_filters, d.stride) for d in dws if d.f_rows == 3] == three
    assert all(d.padding == d.f_rows // 2 for d in dws)
    assert sum(d.f_rows == 5 for d in dws) == five
    assert sum(isinstance(m, BatchNormLayer) for m in net.modules()) == bns
    assert sum(p.numel() for p in net.parameters()) == params


def test_resnet50_stem_and_skips():
    """A 7x7/s2 stem with padding 3, then a 2x2/s2 max pool; each stage's
    first block reduces with a strided 1x1 and projects its skip through a
    strided pointwise conv with no BN after it."""
    net = _model("ResNet50", "torch")
    stem = _by_name(net, "stem")
    assert (stem.f_rows, stem.stride, stem.padding) == (7, 2, 3)
    pool = _by_name(net, "stem_pool")
    assert isinstance(pool, MaxPoolLayer) and pool.stride == 2
    blocks = [l for l in net.layers if isinstance(l, ResidualBlock)]
    assert len(blocks) == 16
    firsts = [b for b in blocks if b.layer_name.endswith("b0")]
    assert [b.layer_list[0].stride for b in firsts] == [1, 2, 2, 2]
    assert [b.skip_projection.stride for b in firsts] == [1, 2, 2, 2]
    assert all(isinstance(b.skip_projection, PointwiseConvLayer) for b in firsts)
    assert all(b.skip_projection is None for b in blocks if b not in firsts)
    assert [type(b.layer_list[i]).__name__ for b in blocks[:1] for i in range(8)] == [
        "PointwiseConvLayer", "BatchNormLayer", "ReLu", "ConvLayer", "BatchNormLayer", "ReLu",
        "PointwiseConvLayer", "BatchNormLayer"]


def test_resnet101_structure_and_forward():
    """23 bottlenecks in the third stage (100 batch norms); a test-mode
    forward of a JAX tree carried across with ``load_numpy_params`` gives
    the JAX net's probs."""
    net = _model("ResNet101", "torch")
    jnet = _model("ResNet101", "jax")
    assert repr(net) == repr(jnet)
    names = [l.layer_name for l in net.layers if isinstance(l, ResidualBlock)]
    assert [sum(n.startswith("s{}b".format(s)) for n in names) for s in (1, 2, 3, 4)] == [
        3, 4, 23, 3]
    assert sum(isinstance(m, BatchNormLayer) for m in net.modules()) == 100
    assert sum(isinstance(m, ConvLayer) for m in net.modules()) == 34
    seeded = _model("ResNet101", "torch")
    seed_serving_weights(seeded, seed=1, calib_hw=(32, 32))
    _set_jax_trees(jnet, seeded.gather_params(), seeded.gather_states())
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    net.load_numpy_params(to_np(jnet.gather_params()), to_np(jnet.gather_states()))
    X = np.random.RandomState(3).randn(2, 3, 32, 32).astype(np.float32)
    _, want = jnet.forward(X, test_mode=True)
    _, probs = net.forward(X, test_mode=True)
    assert float(np.asarray(want).max()) < 0.99  # the seeded weights give no one-hot output
    np.testing.assert_allclose(probs.numpy(), np.asarray(want), **PROBS)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Count the calls of the depthwise kernels' plain versions (what each
    wrapper runs on a CPU tensor, where the card launches the kernel) and
    of batch_norm_stats; record each depthwise layer's input shape, kernel
    and stride."""
    import dorknet_tpu_torch.layers.depthwise_convolution as dw_layer
    import dorknet_tpu_torch.ops.cuda.depthwise as dw_mod
    import dorknet_tpu_torch.ops.norm as norm

    calls = {"fwd": 0, "dx": 0, "dw": 0, "bn": 0, "layers": []}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    def recorded(x, w, b=None, stride=1, padding=1, act=None):
        calls["layers"].append((x.shape[1], x.shape[3], stride, w.shape[-1]))
        return depthwise_conv2d(x, w, b, stride=stride, padding=padding, act=act)

    depthwise_conv2d = dw_layer.depthwise_conv2d
    for name, attr in (("fwd", "depthwise3x3_plain"), ("dx", "depthwise3x3_dx_plain"),
                       ("dw", "depthwise3x3_dw_plain")):
        monkeypatch.setattr(dw_mod, attr, counted(name, getattr(dw_mod, attr)))
    monkeypatch.setattr(norm, "batch_norm_stats", counted("bn", norm.batch_norm_stats))
    monkeypatch.setattr(dw_layer, "depthwise_conv2d", recorded)
    return calls


def _table(layers, k):
    """chip_smoke.py's layout of depthwise layers: (H, C, stride, how many)."""
    out = {}
    for H, C, stride, kk in layers:
        if kk == k:
            out[(H, C, stride)] = out.get((H, C, stride), 0) + 1
    return [key + (n,) for key, n in out.items()]


@pytest.mark.parametrize("kind", ["V3L", "LITE0", "RESNET50"])
def test_chip_smoke_tables_and_launches(kernel_calls, kind):
    """chip_smoke.py's phase-18 tables are what the models feed their
    depthwise layers at 224 px (3x3 ones the kernels, 5x5 ones F.conv2d);
    a test-mode forward runs the depthwise forward once a 3x3 layer, and
    one training step (at 64 px) forward, dx and dw once a 3x3 layer and
    batch_norm_stats once a batch norm: the launches phase 18 requires."""
    import chip_smoke

    z = getattr(chip_smoke, kind)
    net = z.fresh()
    seed_serving_weights(net, seed=0, calib_hw=(32, 32))
    kernel_calls.update(fwd=0, bn=0, layers=[])
    net.forward(np.random.RandomState(0).randn(1, 3, 224, 224).astype(np.float32),
                test_mode=True)
    assert _table(kernel_calls["layers"], 3) == z.dw
    assert _table(kernel_calls["layers"], 5) == z.dw5
    assert [kernel_calls[k] for k in ("fwd", "dx", "dw", "bn")] == [z.dw_layers, 0, 0, 0]
    kernel_calls.update(fwd=0, bn=0)
    X = np.random.RandomState(1).randn(2, 3, 64, 64).astype(np.float32)
    y = np.eye(z.classes, dtype=np.float32)[[0, 1]]
    loss, _ = Trainer(net, SGDMomentum(net, 0.01, 0.9), device="cpu").step(X, y)
    assert np.isfinite(float(loss))
    assert [kernel_calls[k] for k in ("fwd", "dx", "dw", "bn")] == z.want
    assert z.want == {"V3L": [9, 9, 9, 46], "LITE0": [7, 7, 7, 49],
                      "RESNET50": [0, 0, 0, 49]}[kind]
