"""MobileNet-V3 and its layers against the JAX package on the CPU:
``HardSwish``, ``HardSigmoid``, ``SqueezeExciteLayer``, ``MobileNetV3Small``
and ``MobileNetV3Large`` (width 0.5, 48 px, 6 classes).

The layers: forward and input gradient against the JAX layers (layers
rtol 1e-6 / atol 1e-7), with inputs placed exactly at -3 and 3, where the
clip's tie rule gives the gradient; bf16 forwards compared in fp32 after
the cast, within one bf16 rounding; squeeze-excite's zeroed-weights
semantics (``tests/test_models.py:167-188``); the h5 attrs both ways. The
models, from seeded serving weights (``utils/seeded.py``, which seeds the
squeeze-excite FCs): one ``Trainer.step`` against the JAX trainer (loss
rtol 1e-5, parameters and running stats within
``tests/test_torch_trainer.py``'s tolerance), the test-mode probs (rtol
1e-5, atol 1e-6), h5+json written by either package loaded by the other,
the BN fold bit-equal to the JAX fold, and Grad-CAM at ``head_hswish``
against ``dorknet_tpu.cam``; plain CAM raises on the two-stage head in both
packages."""

import copy

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.layers as jlayers  # noqa: E402
import dorknet_tpu.models as jmodels  # noqa: E402
from dorknet_tpu import cam as jcam  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.network import Trainer as JaxTrainer  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402
from dorknet_tpu.regularisers.l2 import l2 as jl2  # noqa: E402
from dorknet_tpu.utils.fold_bn import fold_batch_norms as jax_fold  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
import dorknet_tpu_torch.models as tmodels  # noqa: E402
from dorknet_tpu_torch import cam as tcam  # noqa: E402
from dorknet_tpu_torch.layers import (BatchNormLayer, DepthwiseConvLayer,  # noqa: E402
                                      SqueezeExciteLayer)
from dorknet_tpu_torch.network import FeedForwardNetwork, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402
from dorknet_tpu_torch.regularisers.l2 import l2 as tl2  # noqa: E402
from dorknet_tpu_torch.utils.fold_bn import fold_batch_norms  # noqa: E402
from dorknet_tpu_torch.utils.seeded import seed_serving_weights  # noqa: E402
from tests.test_torch_trainer import TOL, assert_trees_close  # noqa: E402
from tests.test_torch_zoo import PROBS, _compare_layer, _jax_apply, _set_jax_trees  # noqa: E402

SIDE, CLASSES, WIDTH = 48, 6, 0.5
MODELS = ["MobileNetV3Small", "MobileNetV3Large"]


def _np(params):
    return {k: v.detach().numpy() for k, v in params.items()}


def _x_with_ties(shape, seed):
    """Uniform over [-5, 5] with the first values exactly at -3 and 3."""
    x = np.random.RandomState(seed).uniform(-5, 5, shape).astype(np.float32)
    x.flat[:4] = [-3.0, 3.0, -3.0, 3.0]
    return x


@pytest.mark.parametrize("kind", ["HardSwish", "HardSigmoid"])
def test_hard_activations_match_jax(kind):
    """At x = -3 and 3 the clip's tie rule gives JAX's 0.5 share of the
    gradient (HardSwish's dx is -0.25 at -3 and 1.25 at 3; HardSigmoid's
    1/12 at both)."""
    jl, tl = getattr(jlayers, kind)("a"), getattr(tlayers, kind)("a")
    x = _x_with_ties((2, 5, 5, 4), 0)
    _compare_layer(jl, tl, x)
    xt = torch.tensor([-3.0, 3.0], requires_grad=True)
    tl.fapply(xt).sum().backward()
    want = [-0.25, 1.25] if kind == "HardSwish" else [1 / 12, 1 / 12]
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6)
    assert repr(tl) == repr(jl) == "{}(a)".format(kind)


@pytest.mark.parametrize("kind", ["HardSwish", "HardSigmoid", "SqueezeExciteLayer"])
def test_bf16_forward_matches_jax(kind):
    """The same bf16 input through both packages, compared in fp32 after
    the cast, within one bf16 rounding of the output."""
    kw = {"incoming_chans": 16} if kind == "SqueezeExciteLayer" else {}
    np.random.seed(3)
    jl = getattr(jlayers, kind)("a", **kw)
    np.random.seed(3)
    tl = getattr(tlayers, kind)("a", **kw)
    x = _x_with_ties((2, 5, 5, 16), 1)
    want = np.asarray(_jax_apply(jl, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = tl.fapply(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("C, Cr", [(16, None), (40, 16), (96, 24)])
def test_squeeze_excite_matches_jax(C, Cr):
    """Built from one seed (bit-equal glorot weights, in the JAX dict's
    order; Cr defaults to max(8, C // 4)); then with seeded He-normal FCs
    and biases carried across (``utils/seeded.py``'s scales), so the gate
    is not near 0.5 everywhere."""
    np.random.seed(0)
    jl = jlayers.SqueezeExciteLayer("se", incoming_chans=C, reduced_chans=Cr)
    np.random.seed(0)
    tl = tlayers.SqueezeExciteLayer("se", incoming_chans=C, reduced_chans=Cr)
    assert repr(tl) == repr(jl) and tl.reduced_chans == (Cr or max(8, C // 4))
    assert list(tl.get_params()) == list(jl.get_params()) == ["w_reduce", "b_reduce",
                                                              "w_expand", "b_expand"]
    assert_trees_close(_np(tl.get_params()), jl.get_params(), "init", rtol=0, atol=0)
    x = np.random.RandomState(C).randn(3, 6, 6, C).astype(np.float32)
    _compare_layer(jl, tl, x)
    rng = np.random.RandomState(1)
    fan_in = {"w_reduce": C, "w_expand": tl.reduced_chans}
    tree = {k: rng.randn(*v.shape).astype(np.float32) * (
        np.sqrt(2.0 / fan_in[k]) if k in fan_in else 0.1) for k, v in tl.get_params().items()}
    tl.set_params(tree)
    jl.set_params(jax.tree_util.tree_map(jnp.asarray, tree))
    # channel means that differ from image to image, so the gates do too
    x = x + 2.0 * np.random.RandomState(2).randn(3, 1, 1, C).astype(np.float32)
    # the squeeze (a mean over H x W) and the two FCs sum in another order in
    # each package, and an informative gate passes their rounding on: its
    # error is a sum's, absolute on the scale of the terms (max |x|), where
    # the near-constant glorot gate above kept it relative
    y = _compare_layer(jl, tl, x, tol=dict(rtol=1e-6, atol=1e-6 * float(np.abs(x).max())))
    gate = (y / torch.from_numpy(x)).detach()
    assert float(gate.max() - gate.min()) > 0.5


def test_squeeze_excite_zeroed_weights_give_half():
    """``tests/test_models.py:167-188`` held against JAX: with every FC
    weight and bias zero the gate is hardsigmoid(0) = 0.5, so y is exactly
    x / 2; the gradients of sum(y**2) reach all four parameters and equal
    JAX's."""
    np.random.seed(0)
    jl = jlayers.SqueezeExciteLayer("se", incoming_chans=8, reduced_chans=4)
    np.random.seed(0)
    tl = tlayers.SqueezeExciteLayer("se", incoming_chans=8, reduced_chans=4)
    x = np.random.RandomState(0).randn(2, 5, 5, 8).astype(np.float32)
    zeroed = {k: np.zeros(v.shape, np.float32) for k, v in tl.get_params().items()}
    tl.set_params(zeroed)
    y = tl.fapply(torch.from_numpy(x), True)
    np.testing.assert_array_equal(y.detach().numpy(), x * 0.5)
    jy, _ = jl.fapply(jax.tree_util.tree_map(jnp.asarray, zeroed), {}, jnp.asarray(x), True)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    # the glorot weights back, so the reduce FC's gradient is not 0
    np.random.seed(0)
    tl = tlayers.SqueezeExciteLayer("se", incoming_chans=8, reduced_chans=4)
    (tl.fapply(torch.from_numpy(x), True) ** 2).sum().backward()
    want = jax.grad(lambda p: jnp.sum(jl.fapply(p, {}, jnp.asarray(x), True)[0] ** 2))(
        jl.learned_params)
    got = {k: p.grad.numpy() for k, p in tl.get_params().items()}
    assert all(np.isfinite(v).all() for v in got.values())
    assert np.abs(got["w_reduce"]).max() > 0 and np.abs(got["b_expand"]).max() > 0
    assert_trees_close(got, want, "SE parameter gradients", rtol=1e-5, atol=1e-7)


def test_squeeze_excite_reg_loss_covers_both_weights():
    np.random.seed(0)
    jl = jlayers.SqueezeExciteLayer("se", incoming_chans=16, weight_regulariser=jl2(0.01))
    np.random.seed(0)
    tl = tlayers.SqueezeExciteLayer("se", incoming_chans=16, weight_regulariser=tl2(0.01))
    want = float(jl.reg_loss(jl.learned_params))
    np.testing.assert_allclose(float(tl.reg_loss().detach()), want, rtol=1e-6)
    np.testing.assert_allclose(
        want, 0.005 * sum(float((p.detach() ** 2).sum()) for p in (tl.w_reduce, tl.w_expand)),
        rtol=1e-6)
    assert tlayers.SqueezeExciteLayer("bare").reg_loss() == 0.0


@pytest.mark.parametrize("kind", ["HardSwish", "HardSigmoid", "SqueezeExciteLayer"])
def test_layer_h5_both_ways(kind, tmp_path):
    """The same file from both packages' writers (attrs of the same types,
    the same datasets); each package reads the other's into a layer built
    from its name alone. Squeeze-excite's regulariser lives on w_reduce
    only; a file written without grads raises KeyError unless the load
    leaves the grads out."""
    kw = {}
    if kind == "SqueezeExciteLayer":
        kw = dict(incoming_chans=24, reduced_chans=8)
    made = {}
    for pkg, reg in ((jlayers, jl2), (tlayers, tl2)):
        np.random.seed(0)
        extra = {"weight_regulariser": reg(0.003)} if kw else {}
        made[pkg] = getattr(pkg, kind)("l", **kw, **extra)
    for writer, reader in ((jlayers, tlayers), (tlayers, jlayers)):
        path = str(tmp_path / "{}.h5".format(writer.__name__))
        with h5py.File(path, "w") as f:
            made[writer].save_to_h5(f)
        with h5py.File(path, "r") as f:
            assert f["l/layer_info"].attrs["type"] == kind
            back = getattr(reader, kind)("l")
            back.load_from_h5(f)
        assert repr(back) == repr(made[writer])
        if kw:
            got, want = back.get_params(), made[writer].get_params()
            if reader is tlayers:
                got = _np(got)
            else:
                want = _np(want)
            assert_trees_close(got, want, "params", rtol=0, atol=0)
    with h5py.File(str(tmp_path / "dorknet_tpu.layers.h5"), "r") as fj, \
            h5py.File(str(tmp_path / "dorknet_tpu_torch.layers.h5"), "r") as ft:
        names = []
        fj.visit(names.append)
        got = []
        ft.visit(got.append)
        assert sorted(got) == sorted(names)
        for name in names:
            for k, v in fj[name].attrs.items():
                assert type(ft[name].attrs[k]) is type(v), (name, k)
                np.testing.assert_array_equal(ft[name].attrs[k], v)
            if isinstance(fj[name], h5py.Dataset) and fj[name].shape:
                np.testing.assert_array_equal(ft[name][:], fj[name][:])
        if kw:
            reg_on = [n for n in names if "weight_regulariser_type" in fj[n].attrs]
            assert reg_on == ["l/w_reduce"]
    if kw:
        path = str(tmp_path / "nograds.h5")
        with h5py.File(path, "w") as f:
            made[tlayers].save_to_h5(f, save_grads=False)
        with h5py.File(path, "r") as f:
            for pkg in (jlayers, tlayers):
                with pytest.raises(KeyError):
                    getattr(pkg, kind)("l").load_from_h5(f)
            back = tlayers.SqueezeExciteLayer("l")
            back.load_from_h5(f, load_grads=False)
        assert back.grads == {} and repr(back) == repr(made[tlayers])


def _model(kind, pkg):
    np.random.seed(0)
    models = jmodels if pkg == "jax" else tmodels
    return getattr(models, kind)("mnv3", num_classes=CLASSES, width_mult=WIDTH)


@pytest.fixture(scope="module")
def stepped():
    """Each model in both packages after one SGDMomentum step on the same
    batch, from seeded serving weights carried across."""
    out = {}
    for kind in MODELS:
        jnet, net = _model(kind, "jax"), _model(kind, "torch")
        assert repr(net) == repr(jnet)
        assert_trees_close(net.gather_params(), jnet.gather_params(), "init", rtol=0, atol=0)
        seed_serving_weights(net, seed=0, calib_hw=(SIDE, SIDE))
        _set_jax_trees(jnet, net.gather_params(), net.gather_states())
        rng = np.random.RandomState(2)
        X = rng.randn(4, 3, SIDE, SIDE).astype(np.float32)
        y = np.eye(CLASSES, dtype=np.float32)[rng.randint(0, CLASSES, 4)]
        jloss, jpreds = JaxTrainer(jnet, JaxSGDMomentum(jnet, 0.01, 0.9)).step(X, y)
        loss, preds = Trainer(net, SGDMomentum(net, 0.01, 0.9), device="cpu").step(X, y)
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
    np.testing.assert_allclose(probs.numpy().sum(1), 1.0, rtol=1e-5)
    jsame = _model(kind, "jax")
    _set_jax_trees(jsame, net.gather_params(), net.gather_states())
    np.testing.assert_allclose(probs.numpy(), np.asarray(jsame.forward(X, test_mode=True)[1]),
                               **PROBS)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jnet.forward(X, test_mode=True)[1]),
                               **TOL)


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


@pytest.mark.parametrize("kind", MODELS)
def test_fold_matches_jax(stepped, kind):
    """The BN fold of a stepped MobileNet-V3 bit-equal to the JAX fold (the
    squeeze-excite layers copied unfolded), and its probs within 1e-4 of
    the unfolded net's."""
    jnet, net, X, *_ = stepped[kind]
    jsame = _model(kind, "jax")
    _set_jax_trees(jsame, net.gather_params(), net.gather_states())
    folded = fold_batch_norms(net)
    got = folded.gather_params()
    want = jax.tree_util.tree_map(np.asarray, jax_fold(jsame).gather_params())
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert not [m for m in folded.modules() if isinstance(m, BatchNormLayer)]
    assert [m.layer_name for m in folded.modules() if isinstance(m, SqueezeExciteLayer)] == [
        m.layer_name for m in net.modules() if isinstance(m, SqueezeExciteLayer)]
    _, unfolded = net.forward(X, test_mode=True)
    _, probs = folded.forward(X, test_mode=True)
    np.testing.assert_allclose(probs.numpy(), unfolded.numpy(), rtol=1e-4, atol=1e-5)


def test_folded_runner_refresh_refolds(stepped):
    """``InferenceRunner(fold_bn=True).refresh()`` after a training step
    writes the new fold into the served copy in place (the squeeze-excite
    layers copied, nested in ResidualBlocks or not): its probs are a fresh
    fold's, bit for bit."""
    from dorknet_tpu_torch.network import InferenceRunner

    _, net, X, *_ = stepped["MobileNetV3Small"]
    net = copy.deepcopy(net)
    runner = InferenceRunner(net, batch_size=4, device="cpu", fold_bn=True)
    ptrs = [p.data_ptr() for p in runner.network.parameters()]
    y = np.eye(CLASSES, dtype=np.float32)[[0, 1, 2, 3]]
    Trainer(net, SGDMomentum(net, 0.01, 0.9), device="cpu").step(X, y)
    before = runner.predict_probs(X)
    runner.refresh()
    assert [p.data_ptr() for p in runner.network.parameters()] == ptrs
    _, want = fold_batch_norms(net).forward(X, test_mode=True)
    got = runner.predict_probs(X)
    np.testing.assert_array_equal(got, want.numpy())
    assert np.abs(got - before).max() > 0


# (3x3 depthwise (C, stride), 5x5 depthwise, batch norms, squeeze-excites)
# at full width, as the JAX builders give them
FULL_WIDTH = {
    "MobileNetV3Large": ([(16, 1), (64, 2), (72, 1), (240, 2), (200, 1), (184, 1), (184, 1),
                          (480, 1), (672, 1)], 6, 46, 8),
    "MobileNetV3Small": ([(16, 2), (72, 2), (88, 1)], 8, 34, 9),
}


@pytest.mark.parametrize("kind", MODELS)
def test_full_width_structure(kind):
    """The layer counts at 1,000 classes: the 3x3 depthwise layers (padding
    1: the kernels' route) and the 5x5 ones (padding 2: F.conv2d); the
    JAX model's repr and parameter count."""
    np.random.seed(0)
    net = getattr(tmodels, kind)("full")
    dws = [m for m in net.modules() if isinstance(m, DepthwiseConvLayer)]
    three, five, bns, ses = FULL_WIDTH[kind]
    assert [(d.num_filters, d.stride) for d in dws if d.f_rows == 3] == three
    assert all(d.padding == d.f_rows // 2 for d in dws)
    assert sum(d.f_rows == 5 for d in dws) == five
    assert sum(isinstance(m, BatchNormLayer) for m in net.modules()) == bns
    assert sum(isinstance(m, SqueezeExciteLayer) for m in net.modules()) == ses
    assert net.layers[-1].weights.shape == (net._FC_DIM, 1000)
    if kind == "MobileNetV3Large":
        assert sum(p.numel() for p in net.parameters()) == 5483032


def test_large_bneck0_starts_at_the_depthwise():
    """``tests/test_models.py:218-237``: Large's first bneck has exp ==
    in_ch, so no expand pointwise; stride 1 with matching channels puts it
    in a ResidualBlock whose list starts at the depthwise, with an
    IdentityLayer join; its squeeze-excite widths are _make_divisible(exp
    // 4)."""
    net = _model("MobileNetV3Large", "torch")
    bneck0 = next(l for l in net.layers if l.layer_name == "bneck0")
    inner = [l.layer_name for l in bneck0.layer_list]
    assert inner[0] == "bneck0_dw" and "bneck0_expand" not in inner
    assert bneck0.skip_projection is None
    assert isinstance(bneck0.post_skip_activation, tlayers.IdentityLayer)
    ses = [m for m in net.modules() if isinstance(m, SqueezeExciteLayer)]
    assert all(m.reduced_chans == tmodels.mobilenet_v2._make_divisible(m.incoming_chans // 4)
               for m in ses)


def test_gradcam_at_head_hswish_matches_jax(stepped):
    """Grad-CAM differentiates through the squeeze-excite gates, the
    hard-swishes and the two-stage head: the port against
    ``dorknet_tpu.cam`` on the same tree (scores, and maps where the JAX
    map is not all 0)."""
    _, net, X, *_ = stepped["MobileNetV3Small"]
    jsame = _model("MobileNetV3Small", "jax")
    _set_jax_trees(jsame, net.gather_params(), net.gather_states())
    args = dict(top_k=2, terminal_layer_name="head_hswish", out_size=32)
    scores, cams = tcam.compute_gradcam_scores_batch(net, X, **args)
    jscores, jcams = jcam.compute_gradcam_scores_batch(jsame, X, **args)
    assert tuple(cams.shape) == (4, 2, 32, 32)
    c = cams.numpy()
    assert np.isfinite(c).all() and c.min() >= 0.0 and c.max() <= 1.0 + 1e-5
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), **PROBS)
    jc = np.asarray(jcams)
    live = jc.reshape(-1, 32 * 32).max(1) > 0
    assert live.any()
    np.testing.assert_allclose(c.reshape(-1, 32 * 32)[live], jc.reshape(-1, 32 * 32)[live],
                               atol=1e-4)


@pytest.mark.parametrize("fn", ["compute_cam_scores", "compute_cam_scores_batch"])
def test_plain_cam_raises_on_two_stage_head(stepped, fn):
    """The classifier's rows lie over the 1,024 hidden units, not the
    tap's conv channels: the JAX package's einsum raises, and so does the
    port."""
    _, net, X, *_ = stepped["MobileNetV3Small"]
    jsame = _model("MobileNetV3Small", "jax")
    _set_jax_trees(jsame, net.gather_params(), net.gather_states())
    X1 = X[:1]
    with pytest.raises((TypeError, ValueError)):
        getattr(jcam, fn)(jsame, X1, terminal_layer_name="head_hswish", out_size=32)
    with pytest.raises(ValueError, match="Grad-CAM"):
        getattr(tcam, fn)(net, X1, terminal_layer_name="head_hswish", out_size=32)


def test_clip_constants_made_in_inference_mode_train_later():
    """The clips' constants are cached 0-dim CPU tensors; one first asked
    for under ``torch.inference_mode`` (a served forward) must still be
    saved by autograd in a later training step."""
    from dorknet_tpu_torch.layers import activations

    activations.constant.cache_clear()
    x = torch.tensor([-4.0, -3.0, 0.5, 3.0, 4.0])
    with torch.inference_mode():
        tlayers.HardSwish("a").fapply(x)
        tlayers.ReLu6("b").fapply(x)
    xt = x.clone().requires_grad_()
    (tlayers.HardSwish("a").fapply(xt) + tlayers.ReLu6("b").fapply(xt)).sum().backward()
    # HardSwish's (x + 3) / 6 + x / 6 inside, -0.25 at -3 and 1.25 at 3 (the
    # tie), 1 above 3; ReLu6's 1 between 0 and 6
    np.testing.assert_allclose(xt.grad.numpy(), [0.0, -0.25, 4.0 / 6 + 1.0, 1.25 + 1.0,
                                                 1.0 + 1.0], rtol=1e-6)


def test_exported_program_matches_runner(tmp_path):
    """A BN-folded MobileNet-V3-Small exported by ``export_program`` (its
    clips' constants, squeeze-excite and 5x5 layers inside) and reloaded
    serves the runner's probs bit for bit, its 3x3 layers as calls of the
    registered op."""
    from dorknet_tpu_torch.network import InferenceRunner
    from dorknet_tpu_torch.serving_artifact import deserialize, load_serving_artifact

    net = _model("MobileNetV3Small", "torch")
    seed_serving_weights(net, seed=0, calib_hw=(SIDE, SIDE))
    runner = InferenceRunner(net, batch_size=4, device="cpu", fold_bn=True)
    data = runner.export_program((SIDE, SIDE), path=str(tmp_path / "v3s.pt2"))
    ops = sum(n.target is torch.ops.dorknet.depthwise3x3.default
              for n in deserialize(data).graph.nodes)
    assert ops == 3  # Small's three 3x3 depthwise layers
    X = np.random.RandomState(5).randn(6, 3, SIDE, SIDE).astype(np.float32)
    np.testing.assert_array_equal(load_serving_artifact(data).predict_probs(X),
                                  runner.predict_probs(X))
