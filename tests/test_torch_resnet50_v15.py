"""ResNet-50 v1.5 in the port, on the CPU.

- ``MaxPoolLayer``'s overlapping, padded pool against ``F.max_pool2d`` on
  NCHW, forward and gradient; its h5 attrs, and a file without them loading
  as window = stride, padding 0.
- ``ResidualBlock`` with a projection BN (``skip_bn``): its trees, state,
  gradients, h5 and ``torch_io`` restore.
- ``ResNet50(v1_5=True)``: the published layout, 25,557,032 parameters and
  53 BNs at 1,000 classes; the default layout still 25,549,352 and 49.
- The port against the benchmark's plain reference
  (``benchmark_torch/reference/resnet50.py``) at full widths, 64 px, batch
  4, 10 classes, on the benchmark's seeded weights placed through
  ``harness/weights.load_into``: eval probabilities, the train-mode loss,
  every leaf's gradient, one ``SGDMomentum`` step and the running
  statistics, against the reference in float64; the bf16 path fails.
- ``fold_bn`` folds the projection BN; ``InferenceRunner`` serves the
  folded network.

Tolerances, each set from the readings of the test's two seeds against the
float64 reference (fp32 reading; bf16 reading):

- eval probabilities within 1e-6 + 3e-4 p: fp32 reads at most 0.31 of
  that, bf16 1,500 to 1,800 times it; the loss within 1e-4 relative: fp32
  1.1e-6 to 7.3e-6, bf16 2.4e-2 to 4.7e-2; the running stats within 2e-4
  of each leaf's largest value: fp32 2.2e-5 to 3.4e-5, bf16 0.17 to 0.20.
  These are forwards; fp32 computes them to about 1e-5 or better.
- every leaf's gradient, and one step's change, within 0.08 of the larger
  of the leaf's reference norm and the median leaf's: fp32 reads 0.021 to
  0.030, bf16 1.5. The backward of a 50-layer network of train-mode BNs at
  its initial weights amplifies rounding: the reference's own fp32
  gradient lies 2.0-3.7% from its float64 one, every leaf about alike.
"""

import statistics

import h5py
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark_torch.harness import cell as cells
from benchmark_torch.harness import weights
from benchmark_torch.optimisers import SGDMomentum as bench_sgd
from benchmark_torch.reference import resnet50 as ref
from benchmark_torch.reference import train as ref_train
from benchmark_torch.reference.plain import Executor, layer_table
from dorknet_tpu_torch import config
from dorknet_tpu_torch.layers import (BatchNormLayer, ConvLayer, DenseLayer,
                                      GlobalAveragePoolingLayer, MaxPoolLayer,
                                      PointwiseConvLayer, ReLu, ResidualBlock,
                                      SoftmaxWithCrossEntropy)
from dorknet_tpu_torch.layers.base import Layer, to_nhwc
from dorknet_tpu_torch.models import ResNet50
from dorknet_tpu_torch.network import FeedForwardNetwork, InferenceRunner, Trainer
from dorknet_tpu_torch.utils import torch_io
from dorknet_tpu_torch.utils.fold_bn import fold_batch_norms, refold

SIDE, BATCH, CLASSES = 64, 4, 10
PROBS_TOL = (1e-6, 3e-4)   # (atol, rtol)
LOSS_RTOL = 1e-4
STATS_TOL = 2e-4
GRAD_TOL = 0.08


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    side by side, and ResNet-50's convolutions on OpenMP pools
    oversubscribed that way run ten times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the padded pool --------------------------------------------------------
@pytest.mark.parametrize("window, stride, padding, hw", [(3, 2, 1, 12), (3, 2, 1, 11),
                                                         (3, 1, 1, 6), (2, 2, 0, 7)])
def test_max_pool_against_nchw(window, stride, padding, hw):
    """Distinct values, so both send the gradient to the same maximum."""
    x = torch.randperm(2 * 5 * hw * hw, generator=torch.Generator().manual_seed(hw)).float()
    x = x.reshape(2, 5, hw, hw)
    layer = MaxPoolLayer("p", stride=stride, window=window, padding=padding)
    xt = to_nhwc(x).requires_grad_()
    y = layer.fapply(xt)
    xr = x.clone().requires_grad_()
    want = F.max_pool2d(xr, kernel_size=window, stride=stride, padding=padding)
    assert y.is_contiguous()
    torch.testing.assert_close(y.permute(0, 3, 1, 2), want, rtol=0, atol=0)
    r = torch.randn(want.shape, generator=torch.Generator().manual_seed(1))
    (y.permute(0, 3, 1, 2) * r).sum().backward()
    (want * r).sum().backward()
    torch.testing.assert_close(xt.grad.permute(0, 3, 1, 2), xr.grad, rtol=0, atol=0)


def test_max_pool_h5_attrs(tmp_path):
    """A padded pool writes its window and padding; a default pool writes
    only its stride, as the reference, and such a file (as every file the
    reference or the JAX package writes) loads as window = stride, padding
    0."""
    path = str(tmp_path / "p.h5")
    with h5py.File(path, "w") as f:
        MaxPoolLayer("padded", stride=2, window=3, padding=1).save_to_h5(f)
        MaxPoolLayer("plain", stride=3).save_to_h5(f)
    with h5py.File(path, "r") as f:
        assert set(f["plain/layer_info"].attrs) == {"type", "stride"}
        padded, plain = MaxPoolLayer("padded"), MaxPoolLayer("plain")
        padded.load_from_h5(f)
        plain.load_from_h5(f)
    assert (padded.window, padded.stride, padded.padding) == (3, 2, 1)
    assert (plain.window, plain.stride, plain.padding) == (3, 3, 0)
    assert repr(padded) == "MaxPoolLayer(stride=2, window=3, padding=1)"
    assert repr(plain) == "MaxPoolLayer(stride=3)"


# ---- the projection BN ------------------------------------------------------
def _block():
    np.random.seed(3)
    return ResidualBlock(
        "b", layer_list=[PointwiseConvLayer("b_pw", filter_block_shape=(8, 4), stride=2,
                                            with_bias=False),
                         BatchNormLayer("b_bn", incoming_chans=8)],
        skip_projection=PointwiseConvLayer("b_skip", filter_block_shape=(8, 4), stride=2,
                                           with_bias=False),
        skip_bn=BatchNormLayer("b_skip_bn", incoming_chans=8),
        post_skip_activation=ReLu("b_relu"))


def _block_net():
    """The block, global average pooling, a dense layer and the loss."""
    net = FeedForwardNetwork("blk")
    net.add_layer(_block())
    net.add_layer(GlobalAveragePoolingLayer("gap"))
    net.add_layer(DenseLayer("dense", incoming_chans=8, output_dim=3))
    net.set_loss_layer(SoftmaxWithCrossEntropy("sm"))
    return net


def test_skip_bn_trees_state_and_grads():
    """The skip's BN sits in every tree under "skip_bn" and takes its own
    batch statistics in a train-mode forward; a block without one has the
    JAX package's trees, and a skip_bn needs a skip projection."""
    net = _block_net()
    blk = net.layers[0]
    x = to_nhwc(torch.randn(4, 4, 6, 6, generator=torch.Generator().manual_seed(0)))
    y = blk.fapply(x, train=True)
    skip = blk.skip_projection.fapply(x)
    mean = skip.mean(dim=(0, 1, 2))
    torch.testing.assert_close(blk.skip_bn.running_mean.reshape(-1), mean)
    assert set(blk.get_params()) == {"layers", "skip", "skip_bn", "act"}
    assert set(blk.get_params()["skip_bn"]) == {"gamma", "beta"}
    assert set(blk.get_state()["skip_bn"]) == {"running_mean", "running_std"}
    assert y.shape == (4, 3, 3, 8)
    plain = ResidualBlock("p", layer_list=[ReLu("p_r")], skip_projection=None,
                          post_skip_activation=ReLu("p_j"))
    assert set(plain.get_params()) == {"layers", "skip", "act"}
    with pytest.raises(ValueError, match="needs a skip_projection"):
        ResidualBlock("q", layer_list=[ReLu("q_r")],
                      skip_bn=BatchNormLayer("q_bn", incoming_chans=4),
                      post_skip_activation=ReLu("q_j"))


def _trained_block_net():
    net = _block_net()
    X = torch.randn(4, 4, 6, 6, generator=torch.Generator().manual_seed(1)).numpy()
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    net.forward(X, y)
    net.backward()
    return net, X, y


def test_skip_bn_gradients_set_and_read():
    """``backward()`` hands the skip's BN its gradients; ``set_grads`` and
    ``set_params`` / ``set_state`` walk it."""
    net, _, _ = _trained_block_net()
    blk = net.layers[0]
    grads = blk.get_grads()
    assert set(grads["skip_bn"]) == {"gamma", "beta"}
    assert float(grads["skip_bn"]["beta"].abs().sum()) > 0
    zero = {k: torch.zeros_like(v) for k, v in grads["skip_bn"].items()}
    blk.set_grads(dict(grads, skip_bn=zero))
    assert float(blk.skip_bn.grads["beta"].abs().sum()) == 0
    tree, stree = net.gather_params()[0], net.gather_states()[0]
    params = {k: v + 1 for k, v in tree["skip_bn"].items()}
    state = {k: v * 2 for k, v in stree["skip_bn"].items()}
    blk.set_params(dict(tree, skip_bn=params))
    blk.set_state(dict(stree, skip_bn=state))
    np.testing.assert_array_equal(blk.skip_bn.gamma.detach().numpy(), params["gamma"])
    np.testing.assert_array_equal(blk.skip_bn.running_std.numpy(), state["running_std"])


def test_skip_bn_h5_and_torch_io(tmp_path):
    """h5 round trip of a block with a projection BN (its attrs name it) and
    a ``torch_io`` restore into a fresh block; both give the same eval
    outputs."""
    net, X, _ = _trained_block_net()
    blk = net.layers[0]
    path = str(tmp_path / "b.h5")
    with h5py.File(path, "w") as f:
        blk.save_to_h5(f)
    with h5py.File(path, "r") as f:
        assert f["b/layer_info"].attrs["skip_bn_name"] == "b_skip_bn"
        back = ResidualBlock("b")
        back.load_from_h5(f)
    assert repr(back) == repr(blk)
    x = to_nhwc(torch.from_numpy(X))
    with torch.no_grad():
        want = blk.fapply(x)
        torch.testing.assert_close(back.fapply(x), want, rtol=0, atol=0)
    np.testing.assert_array_equal(back.skip_bn.grads["beta"], blk.skip_bn.grads["beta"].numpy())
    ckpt = str(tmp_path / "b.pt")
    torch_io.save_checkpoint(ckpt, net)
    fresh = _block_net()
    torch_io.load_checkpoint(ckpt, fresh)
    with torch.no_grad():
        torch.testing.assert_close(fresh.layers[0].fapply(x), want, rtol=0, atol=0)


# ---- the published layout ---------------------------------------------------
@pytest.mark.parametrize("v1_5, params, bns", [(True, 25_557_032, 53), (False, 25_549_352, 49)])
def test_layout_counts(v1_5, params, bns):
    net = ResNet50("r50", num_classes=1000, v1_5=v1_5)
    assert sum(p.numel() for p in net.parameters()) == params
    assert sum(isinstance(m, BatchNormLayer) for m in net.modules()) == bns


def test_v15_layout():
    """The stride on each downsampling bottleneck's 3x3, a BN after each of
    the 4 projections, a 3x3/s2 stem pool with padding 1."""
    net = ResNet50("r50", v1_5=True)
    pool = [l for l in net.layers if isinstance(l, MaxPoolLayer)]
    assert [(p.window, p.stride, p.padding) for p in pool] == [(3, 2, 1)]
    blocks = [l for l in net.layers if isinstance(l, ResidualBlock)]
    firsts = [b for b in blocks if b.skip_projection is not None]
    assert [b.layer_name for b in firsts] == ["s1b0", "s2b0", "s3b0", "s4b0"]
    assert [b.layer_list[0].stride for b in blocks] == [1] * 16
    conv3 = [b.layer_list[3] for b in blocks]
    assert all(isinstance(c, ConvLayer) and c.padding == 1 for c in conv3)
    assert [c.stride for c in conv3] == [1, 1, 1, 2, 1, 1, 1, 2] + [1] * 5 + [2, 1, 1]
    assert [b.skip_projection.stride for b in firsts] == [1, 2, 2, 2]
    assert all(isinstance(b.skip_bn, BatchNormLayer)
               and b.skip_bn.layer_name == b.layer_name + "_skip_bn" for b in firsts)
    assert all(b.skip_bn is None for b in blocks if b not in firsts)


def test_v15_h5_json_round_trip(tmp_path):
    """The v1.5 network writes and reads its h5+json checkpoint."""
    net = ResNet50("r50", num_classes=CLASSES, v1_5=True)
    X = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(2)).numpy()
    y = np.eye(CLASSES, dtype=np.float32)[[1, 7]]
    net.forward(X, y)
    h5f, jsf = str(tmp_path / "w.h5"), str(tmp_path / "s.json")
    net.save_weights_to_h5(h5f)
    net.save_layer_structure_to_json(jsf)
    back = FeedForwardNetwork("x")
    back.load_network_from_json_and_h5(jsf, h5f)
    assert repr(back) == repr(net)
    _, want = net.forward(X, test_mode=True)
    _, got = back.forward(X, test_mode=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---- the port against the plain reference -----------------------------------
def _cfg():
    cfg = cells.load("resnet50.train.step").config
    return dict(cfg, image_hw=[SIDE, SIDE], num_classes=CLASSES)


def _double(tree):
    return {k: v.double() for k, v in tree.items()}


def _net(params, stats):
    net = ResNet50("r50", num_classes=CLASSES, v1_5=True)
    return net, weights.load_into(net, params, stats)


def _named_grads(net):
    return {"{}/{}".format(m.layer_name, k): torch.as_tensor(g)
            for m in net.modules() if isinstance(m, Layer) for k, g in m.grads.items()}


def _port(cfg, p0, s0, cal, x, y, dtype):
    """The port's readings in ``dtype``: eval probs, the train-mode loss and
    gradients, one SGDMomentum step's change and the running stats."""
    config.set_compute_dtype(dtype)
    try:
        net, _ = _net(p0, cal)
        _, probs = net.forward(x.numpy(), test_mode=True)
        net, _ = _net(p0, s0)
        loss, _ = net.forward(x.numpy(), y.numpy())
        net.backward()
        grads = _named_grads(net)
        stats = weights.program_stats(net, set(s0))
        net, placed = _net(p0, s0)
        Trainer(net, bench_sgd.program(cfg["train"], net), device="cpu").step(x, y)
        change = {k: p.detach().reshape(p0[k].shape) - p0[k] for k, p in placed.items()}
    finally:
        config.set_compute_dtype(torch.float32)
    return dict(probs=probs.double(), loss=float(loss), grads=grads, stats=stats, change=change)


@pytest.fixture(scope="module", params=[1, 2], ids=["seed1", "seed2"])
def readings(request):
    cfg = _cfg()
    spec, _, _ = layer_table(ref.forward, cfg, BATCH)
    p0 = weights.make_params(spec, request.param, torch.device("cpu"), dense_std=0.01)
    s0 = weights.train_stats(spec, p0)
    cal = weights.calibrated_stats(ref.forward, cfg, p0, request.param, torch.device("cpu"))
    gen = torch.Generator().manual_seed(request.param)
    x = torch.randn((BATCH, 3, SIDE, SIDE), generator=gen)
    y = F.one_hot(torch.randint(0, CLASSES, (BATCH,), generator=gen), CLASSES).float()
    p64 = _double(p0)
    with torch.no_grad():
        ex = Executor("eval", p64, {k: (m.double(), s.double()) for k, (m, s) in cal.items()})
        probs = torch.softmax(ref.forward(ex, x.double(), cfg), dim=1)
    loss, grads, stats = ref_train.step(ref.forward, cfg, p64, {
        k: (m.double(), s.double()) for k, (m, s) in s0.items()}, x.double(), y.double())
    lr = cfg["train"]["learning_rate"]
    want = dict(probs=probs, loss=loss, grads=grads, stats=stats,
                change={k: -lr * g for k, g in grads.items()})
    got = {dt: _port(cfg, p0, s0, cal, x, y, dt) for dt in (torch.float32, torch.bfloat16)}
    return want, got


def _gaps(want, got):
    """Each reading's worst gap, in the units of its tolerance."""
    med = statistics.median(float(g.norm()) for g in want["grads"].values())

    def leaf_gap(a, b, floor):
        return max(float((a[k].double().reshape(b[k].shape) - b[k]).norm())
                   / max(float(b[k].norm()), floor) for k in b)

    stats = max(float((got["stats"][k][j].double() - want["stats"][k][j]).abs().max()
                      / want["stats"][k][j].abs().max()) for k in want["stats"] for j in (0, 1))
    lr = _cfg()["train"]["learning_rate"]
    return dict(
        probs=float(((got["probs"] - want["probs"]).abs()
                     / (PROBS_TOL[0] + PROBS_TOL[1] * want["probs"])).max()),
        loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]) / LOSS_RTOL,
        grads=leaf_gap(got["grads"], want["grads"], med) / GRAD_TOL,
        change=leaf_gap(got["change"], want["change"], lr * med) / GRAD_TOL,
        stats=stats / STATS_TOL)


def test_port_matches_reference(readings):
    """fp32: eval probs, loss, every leaf's gradient, one step's change and
    the running stats within their tolerances of the float64 reference."""
    want, got = readings
    gaps = _gaps(want, got[torch.float32])
    assert all(v <= 1.0 for v in gaps.values()), gaps


def test_bf16_path_fails_reference(readings):
    want, got = readings
    gaps = _gaps(want, got[torch.bfloat16])
    assert any(v > 1.0 for v in gaps.values()), gaps
    assert gaps["loss"] > 10 and gaps["grads"] > 10, gaps


# ---- the fold --------------------------------------------------------------
@pytest.fixture(scope="module")
def seeded_v15():
    from dorknet_tpu_torch.utils.seeded import seed_serving_weights

    np.random.seed(0)
    net = ResNet50("r50", num_classes=CLASSES, v1_5=True)
    seed_serving_weights(net, seed=5, calib_hw=(SIDE, SIDE))
    X = np.random.RandomState(6).randn(3, 3, SIDE, SIDE).astype(np.float32)
    return net, X


def test_fold_folds_the_projection_bn(seeded_v15):
    """The folded network loses every BN, the four projection BNs included
    (each skip projection gains a bias), and serves the unfolded network's
    eval probabilities within 1e-5; ``refold`` after a change of the source
    gives the fold of the changed source."""
    net, X = seeded_v15
    folded = fold_batch_norms(net)
    assert not any(isinstance(m, BatchNormLayer) for m in folded.modules())
    skips = [b.skip_projection for b in folded.layers
             if isinstance(b, ResidualBlock) and b.skip_projection is not None]
    assert len(skips) == 4 and all(s.with_bias for s in skips)
    assert all(b.skip_bn is None for b in folded.layers if isinstance(b, ResidualBlock))
    _, want = net.forward(X, test_mode=True)
    assert float(want.max()) < 0.99
    _, probs = folded.forward(X, test_mode=True)
    torch.testing.assert_close(probs, want, rtol=0, atol=1e-5)
    runner = InferenceRunner(net, batch_size=2, device="cpu", fold_bn=True)
    np.testing.assert_allclose(runner.predict_probs(X), want.numpy(), rtol=0, atol=1e-5)
    with torch.no_grad():
        for b in net.layers:
            if isinstance(b, ResidualBlock) and b.skip_bn is not None:
                b.skip_bn.running_std.mul_(1.5)
    _, changed = net.forward(X, test_mode=True)
    refold(folded, net)
    _, probs = folded.forward(X, test_mode=True)
    torch.testing.assert_close(probs, changed, rtol=0, atol=1e-5)
    assert float((changed - want).abs().max()) > 1e-3
    with torch.no_grad():
        for b in net.layers:
            if isinstance(b, ResidualBlock) and b.skip_bn is not None:
                b.skip_bn.running_std.div_(1.5)


# ---- the reported loss -------------------------------------------------------
def test_loss_finite_where_p_dot_y_underflows():
    """A row whose labelled classes lie more than about 104 logits below the
    largest reads -log(p·y) = inf naively; the port reports it in log space,
    finite and exact, and every finite row within fp32 rounding of
    -log(p·y). The gradient stays (p - y) / B."""
    from dorknet_tpu_torch.ops.loss import softmax_cross_entropy, softmax_probs

    z = torch.tensor([[0.0, 150.0, 1.0], [0.5, 2.0, 3.0], [-200.0, 0.0, 0.0]],
                     dtype=torch.float64).float().requires_grad_()
    y = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.3, 0.7], [0.5, 0.0, 0.5]])
    zd, yd = z.detach().double(), y.double()
    exact = (torch.logsumexp(zd, 1) - torch.logsumexp(zd + torch.log(yd), 1)).mean()
    loss = softmax_cross_entropy(z, y)
    p = softmax_probs(z.detach())
    assert not torch.isfinite(-torch.log((p * y).sum(1))).all()
    torch.testing.assert_close(loss.double(), exact, rtol=1e-6, atol=0)
    loss.backward()
    torch.testing.assert_close(z.grad, (p - y) / 3, rtol=0, atol=0)
    finite = z.detach()[1:2]
    want = torch.mean(-torch.log(torch.sum(softmax_probs(finite) * y[1:2], dim=1)))
    torch.testing.assert_close(softmax_cross_entropy(finite, y[1:2]), want, rtol=1e-6, atol=0)
