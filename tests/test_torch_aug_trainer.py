"""The augmented training steps against the JAX package on the CPU, and
their equalities within the port.

``Trainer.step_augmented`` of both packages from the same fresh weights and
the same uint8 precrop batches, with the JAX package's augmentation and
mixup draws handed to the port, on the narrow net of
``tests/test_device_dataset.py`` and on ResNet18 at full width. Tolerances
are the training slice's (fp32 on both sides, sums in different orders):
loss 1e-4 relative; parameters, running stats and EMA 1e-4 relative / 1e-5
absolute. Within the port the equalities are exact: the same operations run
in the same order."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.layers as jlayers  # noqa: E402
from dorknet_tpu.models import ResNet18 as JaxResNet18  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.network import Trainer as JaxTrainer  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
from dorknet_tpu_torch.data_loading.device_augment import train_pipeline  # noqa: E402
from dorknet_tpu_torch.models import ResNet18  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402
from tests.test_torch_augment import (inject_draws, jax_pipeline_draws,  # noqa: E402
                                      structured_images)
from tests.test_torch_trainer import assert_trees_close  # noqa: E402

AUG = dict(hsv_pert_tuples=((0.9, 1.1), (0.5, 2.0), (0.5, 2.0)),
           rotation_tuple=(-15.0, 15.0), horizontal_flip_prob=0.5,
           crop_mode="random", mixup=(0.0, 0.3))
PIPELINE_CFG = {k: v for k, v in AUG.items() if k != "mixup"}


def small_net(L, network_cls):
    """The narrow net of tests/test_device_dataset.py: conv, BN, ReLU, GAP,
    dense to 3 classes."""
    np.random.seed(7)
    net = network_cls("small")
    net.add_layer(L.ConvLayer("conv0", filter_block_shape=(8, 3, 3, 3), with_bias=False))
    net.add_layer(L.BatchNormLayer("bn0", incoming_chans=8))
    net.add_layer(L.ReLu("relu0"))
    net.add_layer(L.GlobalAveragePoolingLayer("gap"))
    net.add_layer(L.DenseLayer("dense1", incoming_chans=8, output_dim=3))
    net.set_loss_layer(L.SoftmaxWithCrossEntropy("softmax"))
    return net


def precrop_batches(seed, steps, B, hw, classes):
    X = np.stack([structured_images(seed + k, B, *hw) for k in range(steps)])
    y = np.eye(classes, dtype=np.float32)[
        np.random.RandomState(seed).randint(0, classes, (steps, B))]
    return X, y


def run_aug_pair(monkeypatch, jnet, net, X, y, out_hw, lr, **trainer_args):
    """step_augmented in both packages, step by step, the JAX draws handed
    to the port; compare after every step."""
    jtrainer = JaxTrainer(jnet, JaxSGDMomentum(jnet, lr, 0.9), **trainer_args)
    trainer = Trainer(net, SGDMomentum(net, lr, 0.9), device="cpu", **trainer_args)
    keys = jax.random.split(jax.random.PRNGKey(21), len(X))
    B, H, W = X.shape[1:4]
    inject_draws(monkeypatch, [jax_pipeline_draws(k, B, (H, W), out_hw, PIPELINE_CFG,
                                                  AUG["mixup"]) for k in keys])
    for k in range(len(X)):
        jloss, jpreds = jtrainer.step_augmented(keys[k], X[k], y[k], out_hw, **AUG)
        loss, preds = trainer.step_augmented(torch.Generator(), X[k], y[k], out_hw, **AUG)
        assert preds.shape == (2 * B,)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                                   err_msg="loss, step {}".format(k))
        np.testing.assert_array_equal(preds.numpy(), np.asarray(jpreds))
        assert_trees_close(net.gather_params(), jnet.gather_params(),
                           "params, step {}".format(k))
        assert_trees_close(net.gather_states(), jnet.gather_states(),
                           "BN running stats, step {}".format(k))
    if trainer_args.get("ema_decay") is not None:
        assert_trees_close(trainer.ema_params(), jtrainer.ema_params(), "EMA params")


def test_small_net_three_augmented_steps_match_jax(monkeypatch):
    """Fresh BN, batch 4 of 30x30 uint8 precrops -> 24x24, mixup (8 trained
    images a step), three steps."""
    jnet, net = small_net(jlayers, JaxNetwork), small_net(tlayers, FeedForwardNetwork)
    X, y = precrop_batches(1, 3, 4, (30, 30), 3)
    run_aug_pair(monkeypatch, jnet, net, X, y, (24, 24), lr=0.05)


def test_resnet18_two_augmented_steps_match_jax(monkeypatch):
    """Full widths 64-512, batch 2 of 61x61 precrops -> 49x49 (49 px, as
    the training slice's ResNet18 parity test, for the last BNs' sake), the
    flagship's SGDMomentum(0.9) with clip 1.0 and EMA 0.9, two steps."""
    np.random.seed(0)
    jnet = JaxResNet18("dogs", num_classes=120)
    np.random.seed(0)
    net = ResNet18("dogs", num_classes=120)
    X, y = precrop_batches(2, 2, 2, (61, 61), 120)
    run_aug_pair(monkeypatch, jnet, net, X, y, (49, 49), lr=0.05 * (4 / 200),
                 ema_decay=0.9, clip_norm=1.0)


def twin_trainers(**kwargs):
    nets = [small_net(tlayers, FeedForwardNetwork) for _ in range(2)]
    return nets, [Trainer(n, SGDMomentum(n, 0.05, 0.9), device="cpu", **kwargs) for n in nets]


def assert_nets_equal(a, b):
    for p, q in zip(a.parameters(), b.parameters(), strict=True):
        assert torch.equal(p, q)
    for p, q in zip(a.buffers(), b.buffers(), strict=True):
        assert torch.equal(p, q)


def test_step_augmented_equals_pipeline_then_step():
    """step_augmented == train_pipeline(..., "NHWC") then step of an NHWC
    trainer, under the same generator seed: bit-equal."""
    nets, (ta, _) = twin_trainers()
    tb = Trainer(nets[1], SGDMomentum(nets[1], 0.05, 0.9), device="cpu", input_layout="NHWC")
    X, y = precrop_batches(3, 2, 4, (30, 30), 3)
    ga, gb = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for k in range(2):
        la, pa = ta.step_augmented(ga, X[k], y[k], (24, 24), **AUG)
        x, yy = train_pipeline(gb, torch.from_numpy(X[k]), torch.from_numpy(y[k]), (24, 24),
                               output_layout="NHWC", **AUG)
        lb, pb = tb.step(x, yy)
        assert float(la) == float(lb)
        assert torch.equal(pa, pb)
    assert_nets_equal(*nets)


def test_multi_step_augmented_equals_sequential_steps():
    nets, (ta, tb) = twin_trainers(ema_decay=0.5)
    X, y = precrop_batches(4, 3, 4, (30, 30), 3)
    losses, preds = ta.multi_step_augmented(torch.Generator().manual_seed(8), X, y, (24, 24),
                                            **AUG)
    assert losses.shape == (3,) and preds.shape == (3, 8)
    g = torch.Generator().manual_seed(8)
    for k in range(3):
        loss, p = tb.step_augmented(g, X[k], y[k], (24, 24), **AUG)
        assert float(loss) == float(losses[k])
        assert torch.equal(p, preds[k])
    assert_nets_equal(*nets)


def test_multi_step_augmented_indexed_equals_sequential_steps():
    nets, (ta, tb) = twin_trainers()
    images = torch.from_numpy(structured_images(9, 10, 30, 30))
    labels = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1, 2, 0], dtype=torch.int32)
    rows = np.random.RandomState(10).randint(0, 10, (3, 4)).astype(np.int32)
    losses, preds = ta.multi_step_augmented_indexed(
        torch.Generator().manual_seed(2), images, labels, rows, (24, 24), 3, **AUG)
    assert losses.shape == (3,) and preds.shape == (3, 8)
    g = torch.Generator().manual_seed(2)
    for k in range(3):
        loss, p = tb.step_augmented_indexed(g, images, labels, rows[k], (24, 24), 3, **AUG)
        assert float(loss) == float(losses[k])
        assert torch.equal(p, preds[k])
    assert_nets_equal(*nets)
