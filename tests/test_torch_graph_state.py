"""What a captured training step needs of the trainer's state, checked on
the CPU: a CUDA graph replays reads and writes at the addresses it saw at
capture, so every tensor of the step must be updated in place, and a graph
must be keyed on everything it bakes in.

- from the second step on (the first adopts the batch statistics), every
  parameter, optimiser-cache tensor, EMA leaf, batch-norm running stat and
  the device lr keeps its ``data_ptr()`` across ``step``,
  ``step_augmented_indexed`` and ``accumulate_step``, and ``set_state``
  copies into the running stats;
- the trainer's key (``Trainer._signature``) changes with the optimiser's
  hyperparameters and object, ``add_layer``, clip, EMA, remat, the layout,
  the compute-dtype policy, a batch norm's state and the cuDNN and TF32
  settings of ``torch.backends``, and with nothing else;
- ``Trainer(cuda_graph=True)`` on the CPU trains eagerly, with results
  bit-equal to ``cuda_graph=False``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
from dorknet_tpu_torch import config  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import RMSProp, SGDMomentum  # noqa: E402
from dorknet_tpu_torch.regularisers.l2 import l2 as tl2  # noqa: E402
from tests.test_torch_aug_trainer import AUG, precrop_batches  # noqa: E402
from tests.test_torch_trainer import batches, narrow_net  # noqa: E402


def _state(trainer):
    """Every tensor the step reads or writes besides its inputs."""
    net = trainer.network
    stats = [b for l in net.modules() if isinstance(l, tlayers.BatchNormLayer)
             for b in (l.running_mean, l.running_std)]
    return (list(net.parameters()) + list(trainer._cache) + list(trainer._ema or [])
            + stats + [trainer.optimiser.device_lr()])


def _addresses(trainer):
    return [t.data_ptr() for t in _state(trainer)]


def _trainer(make_opt=SGDMomentum, **kwargs):
    np.random.seed(51)
    net = narrow_net(tlayers, tl2, FeedForwardNetwork)
    opt = make_opt(net, 0.05, 0.9)
    return Trainer(net, opt, ema_decay=0.9, clip_norm=1.0, device="cpu", **kwargs)


@pytest.mark.parametrize("make_opt", [SGDMomentum, RMSProp])
@pytest.mark.parametrize("remat", [False, "blocks"])
def test_step_state_keeps_its_addresses(make_opt, remat):
    trainer = _trainer(make_opt, remat=remat)
    X, y = batches(52, 4, 4, 17, 10)
    trainer.step(X[0], y[0])  # adopts the batch statistics: the stats come into being
    ptrs = _addresses(trainer)
    before = [t.clone() for t in _state(trainer)]
    trainer.step(X[1], y[1])
    trainer.optimiser.multiply_learning_rate(0.5)
    trainer.accumulate_step(X[2:4], y[2:4])
    assert _addresses(trainer) == ptrs
    changed = [not torch.equal(a, b) for a, b in zip(before, _state(trainer), strict=True)]
    assert all(changed), "a tensor of the step was not updated"


def test_augmented_indexed_step_state_keeps_its_addresses():
    np.random.seed(53)
    net = FeedForwardNetwork("aug")
    L = tlayers
    net.add_layer(L.ConvLayer("conv0", filter_block_shape=(8, 3, 3, 3), with_bias=False))
    net.add_layer(L.BatchNormLayer("bn0", incoming_chans=8))
    net.add_layer(L.ReLu("relu0"))
    net.add_layer(L.GlobalAveragePoolingLayer("gap"))
    net.add_layer(L.DenseLayer("dense1", incoming_chans=8, output_dim=3))
    net.set_loss_layer(L.SoftmaxWithCrossEntropy("softmax"))
    trainer = Trainer(net, SGDMomentum(net, 0.05, 0.9), ema_decay=0.9, device="cpu")
    X, _ = precrop_batches(54, 1, 12, (24, 24), 3)
    images = torch.from_numpy(X[0])
    labels = torch.from_numpy(np.random.RandomState(55).randint(0, 3, 12)).int()
    gen = torch.Generator().manual_seed(56)
    rows = np.random.RandomState(57).randint(0, 12, (3, 4))
    trainer.step_augmented_indexed(gen, images, labels, rows[0], (16, 16), 3, **AUG)
    ptrs = _addresses(trainer)
    trainer.step_augmented_indexed(gen, images, labels, rows[1], (16, 16), 3, **AUG)
    trainer.multi_step_augmented_indexed(gen, images, labels, rows[2:], (16, 16), 3, **AUG)
    assert _addresses(trainer) == ptrs


def test_set_state_copies_into_the_running_stats():
    bn = tlayers.BatchNormLayer("bn", incoming_chans=3)
    bn.fapply(torch.randn(4, 5, 5, 3), train=True)
    ptrs = (bn.running_mean.data_ptr(), bn.running_std.data_ptr())
    bn.set_state({"running_mean": np.full((1, 3, 1, 1), 0.5, np.float32),
                  "running_std": np.full((1, 3, 1, 1), 2.0, np.float32)})
    assert (bn.running_mean.data_ptr(), bn.running_std.data_ptr()) == ptrs
    assert float(bn.running_mean.sum()) == 1.5 and float(bn.running_std.sum()) == 6.0
    with pytest.raises(ValueError, match="expected shape"):
        bn.set_state({"running_mean": np.zeros(3, np.float32),
                      "running_std": np.zeros(3, np.float32)})
    fresh = tlayers.BatchNormLayer("fresh", incoming_chans=3)
    fresh.set_state(bn.get_state())
    assert fresh.bn_initialized() and torch.equal(fresh.running_std, bn.running_std)


def test_trainer_key_follows_what_a_step_bakes_in():
    trainer = _trainer()
    X, y = batches(58, 1, 4, 17, 10)
    key = trainer._signature()
    assert trainer._signature() == key  # nothing changed, the same key
    trainer.optimiser.set_learning_rate(0.01)  # the lr is read, not baked in
    assert trainer._signature() == key

    def changes(mutate, undo=None):
        nonlocal key
        mutate()
        new = trainer._signature()
        assert new != key
        if undo is not None:
            undo()
            assert trainer._signature() == key
        key = trainer._signature()

    opt = trainer.optimiser
    changes(lambda: setattr(opt, "momentum", 0.5), lambda: setattr(opt, "momentum", 0.9))
    changes(lambda: setattr(trainer, "clip_norm", 0.5), lambda: setattr(trainer, "clip_norm", 1.0))
    changes(lambda: setattr(trainer, "ema_decay", 0.99), lambda: setattr(trainer, "ema_decay", 0.9))
    changes(lambda: setattr(trainer, "remat", True), lambda: setattr(trainer, "remat", False))
    changes(lambda: setattr(trainer, "input_layout", "NHWC"),
            lambda: setattr(trainer, "input_layout", "NCHW"))
    changes(lambda: config.set_compute_dtype(torch.bfloat16),
            lambda: config.set_compute_dtype(torch.float32))
    other = SGDMomentum(trainer.network, 0.05, 0.9)  # equal hyperparameters, its own state
    changes(lambda: setattr(trainer, "optimiser", other),
            lambda: setattr(trainer, "optimiser", opt))
    rms = RMSProp(trainer.network, 0.05, 0.9)  # the same hyper tuple, another rule
    assert rms.hyper_key() == opt.hyper_key()
    changes(lambda: setattr(trainer, "optimiser", rms), lambda: setattr(trainer, "optimiser", opt))
    trainer.step(X[0], y[0])  # the batch norms' state moves from unset to set
    assert trainer._signature() != key
    key = trainer._signature()
    version = trainer.network._version
    changes(lambda: trainer.network.add_layer(tlayers.ReLu("extra")))
    assert trainer.network._version == version + 1


@pytest.mark.parametrize("flag", ["cudnn.deterministic", "cudnn.benchmark",
                                  "cuda.matmul.allow_tf32", "cudnn.allow_tf32"])
def test_trainer_key_follows_the_backend_flags(flag):
    """A capture bakes in cuDNN's algorithm choice and the TF32 precision."""
    path, name = flag.rsplit(".", 1)
    owner = torch.backends
    for part in path.split("."):
        owner = getattr(owner, part)
    trainer = _trainer()
    key = trainer._signature()
    was = getattr(owner, name)
    try:
        setattr(owner, name, not was)
        assert trainer._signature() != key
    finally:
        setattr(owner, name, was)
    assert trainer._signature() == key


def test_a_new_optimiser_object_gets_fresh_state_and_drops_the_graphs():
    trainer = _trainer()
    X, y = batches(59, 2, 4, 17, 10)
    trainer.step(X[0], y[0])
    cache = trainer._cache
    trainer._graphs["stale"] = object()  # what a capture on the card would leave
    trainer.optimiser = SGDMomentum(trainer.network, 0.05, 0.9)
    trainer.step(X[1], y[1])
    assert trainer._cache is not cache and not trainer._graphs


@pytest.mark.parametrize("entry", ["step", "accumulate_step", "step_augmented"])
def test_cuda_graph_on_the_cpu_trains_eagerly(entry):
    trainers = [_trainer(cuda_graph=flag) for flag in (True, False)]
    assert not trainers[0].cuda_graph and not trainers[1].cuda_graph
    X, y = batches(60, 4, 4, 17, 10)
    Xu, yu = precrop_batches(61, 3, 4, (20, 20), 10)
    results = []
    for t in trainers:
        gen = torch.Generator().manual_seed(62)
        out = []
        for k in range(3):
            if entry == "step":
                out.append(t.step(X[k], y[k])[0])
            elif entry == "accumulate_step":
                out.append(t.accumulate_step(X[k:k + 2], y[k:k + 2]))
            else:
                out.append(t.step_augmented(gen, Xu[k], yu[k], (17, 17), **AUG)[0])
        results.append((out, [p.detach().clone() for p in t.network.parameters()]))
        assert t.captures == 0 and not t._graphs
    (l0, p0), (l1, p1) = results
    assert [float(v) for v in l0] == [float(v) for v in l1]
    assert all(torch.equal(a, b) for a, b in zip(p0, p1, strict=True))
