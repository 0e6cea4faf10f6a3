"""The port's learning-rate schedules and device lr against the JAX
package's, on the CPU.

- ``lr_at`` of ``StepDecay``, ``CosineDecay`` and ``Warmup`` bit-equal to
  the JAX package's over t = 0..40 (both are plain Python in doubles);
- ``apply`` and the optimiser's lr setters fill the device lr in place;
- five steps of the narrow ResNet of ``tests/test_torch_trainer.py`` under
  ``Warmup(StepDecay(...))``, applied before every step, match the JAX
  ``Trainer`` driven by the JAX schedule. Tolerances as the training
  slice's: loss rtol 1e-5; parameters, running stats and EMA rtol 1e-4 /
  atol 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.layers as jlayers  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.network import Trainer as JaxTrainer  # noqa: E402
from dorknet_tpu.optimisers import RMSProp as JaxRMSProp  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402
from dorknet_tpu.regularisers.l2 import l2 as jl2  # noqa: E402
from dorknet_tpu.utils import schedules as jsched  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import SGD, RMSProp, SGDMomentum  # noqa: E402
from dorknet_tpu_torch.regularisers.l2 import l2 as tl2  # noqa: E402
from dorknet_tpu_torch.utils import schedules  # noqa: E402
from tests.test_torch_trainer import assert_trees_close, batches, narrow_net  # noqa: E402


def _schedule_pairs():
    def both(make):
        return make(schedules), make(jsched)

    return {
        "step_decay": both(lambda m: m.StepDecay(0.015, (16, 20, 25), 0.5)),
        "step_decay_dict": both(lambda m: m.StepDecay(0.01, {5: 0.1, 10: 0.3})),
        "cosine": both(lambda m: m.CosineDecay(0.1, 30, min_frac=0.05)),
        "warmup_step": both(lambda m: m.Warmup(m.StepDecay(0.2, (10, 30), 0.1), 5)),
        "warmup_cosine": both(lambda m: m.Warmup(m.CosineDecay(0.05, 40), 8)),
        "warmup_zero": both(lambda m: m.Warmup(m.CosineDecay(0.05, 40), 0)),
    }


@pytest.mark.parametrize("name", sorted(_schedule_pairs()))
def test_lr_at_is_bit_equal_to_jax(name):
    ours, theirs = _schedule_pairs()[name]
    for t in range(41):
        assert ours.lr_at(t) == theirs.lr_at(t), t
        assert ours(t) == theirs(t), t


def test_schedule_arguments_are_checked():
    with pytest.raises(ValueError, match="total"):
        schedules.CosineDecay(0.1, 0)
    with pytest.raises(ValueError, match="warmup"):
        schedules.Warmup(schedules.StepDecay(0.1, ()), -1)
    with pytest.raises(NotImplementedError):
        schedules.LRSchedule().lr_at(0)


@pytest.mark.parametrize("make", [lambda n: SGD(n, 0.1), lambda n: SGDMomentum(n, 0.1, 0.9),
                                  lambda n: RMSProp(n, 0.1, 0.9)],
                         ids=["SGD", "SGDMomentum", "RMSProp"])
def test_apply_fills_the_device_lr_in_place(make):
    """The device lr is a 0-dim fp32 tensor on the network's device, made
    once; every way of setting the lr writes into it."""
    net = FeedForwardNetwork("n")
    net.add_layer(tlayers.BatchNormLayer("bn", input_dimension=2, incoming_chans=3))
    opt = make(net)
    lr = opt.device_lr()
    assert lr.shape == () and lr.dtype == torch.float32 and lr.device == net.device()
    ptr = lr.data_ptr()
    sched = schedules.Warmup(schedules.StepDecay(0.3, (4,), 0.1), 2)
    for t in range(6):
        got = sched.apply(opt, t)
        assert got == sched.lr_at(t) == opt.learning_rate
        assert opt.device_lr() is lr and lr.data_ptr() == ptr
        assert float(lr) == float(np.float32(got))
    opt.set_learning_rate(0.25)
    opt.multiply_learning_rate(0.5)
    opt.learning_rate = opt.learning_rate * 3
    assert opt.device_lr() is lr and float(lr) == float(np.float32(0.375))


def test_hyper_key_names_what_the_update_bakes_in():
    net = FeedForwardNetwork("n")
    assert SGD(net, 0.1).hyper_key() == ()
    opt = SGDMomentum(net, 0.1, 0.9)
    assert opt.hyper_key() == (0.9,)
    opt.momentum = 0.5
    assert opt.hyper_key() == (0.5,)
    assert RMSProp(net, 0.1, 0.99).hyper_key() == (0.99,)
    # the JAX package keys on the same numbers
    assert JaxSGDMomentum(_EmptyJaxNetwork(), 0.1, 0.5).hyper_key() == opt.hyper_key()
    assert JaxRMSProp(_EmptyJaxNetwork(), 0.1, 0.99).hyper_key() == (0.99,)


class _EmptyJaxNetwork:
    """What the JAX optimisers' constructors read of a network."""
    layers = []
    _version = 0


@pytest.mark.parametrize("opt_name", ["SGDMomentum", "RMSProp"])
def test_warmup_step_decay_trajectory_matches_jax(opt_name):
    """Five steps with the lr set by the schedule before each: ramp over
    two steps, then decays at steps 3 and 4. The port's lr reaches the
    update through its device scalar, the JAX package's through its traced
    lr."""
    np.random.seed(21)
    jnet = narrow_net(jlayers, jl2, JaxNetwork)
    np.random.seed(21)
    net = narrow_net(tlayers, tl2, FeedForwardNetwork)
    if opt_name == "SGDMomentum":
        jopt, opt = JaxSGDMomentum(jnet, 0.0, 0.9), SGDMomentum(net, 0.0, 0.9)
    else:
        jopt, opt = JaxRMSProp(jnet, 0.0, 0.9), RMSProp(net, 0.0, 0.9)
    jtrainer = JaxTrainer(jnet, jopt, ema_decay=0.9, clip_norm=1.0)
    trainer = Trainer(net, opt, ema_decay=0.9, clip_norm=1.0, device="cpu")
    base = 0.1 if opt_name == "SGDMomentum" else 0.01
    jschedule = jsched.Warmup(jsched.StepDecay(base, (3, 4), 0.3), 2)
    schedule = schedules.Warmup(schedules.StepDecay(base, (3, 4), 0.3), 2)
    X, y = batches(22, 5, 4, 17, 10)
    lrs = []
    for t in range(5):
        lrs.append(schedule.apply(opt, t))
        assert lrs[-1] == jschedule.apply(jopt, t)
        jloss, _ = jtrainer.step(X[t], y[t])
        loss, _ = trainer.step(X[t], y[t])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   err_msg="loss, step {}".format(t))
        assert_trees_close(net.gather_params(), jnet.gather_params(),
                           "params, step {}".format(t))
        assert_trees_close(net.gather_states(), jnet.gather_states(),
                           "BN running stats, step {}".format(t))
        assert_trees_close(trainer.ema_params(), jtrainer.ema_params(),
                           "EMA params, step {}".format(t))
    assert len(set(lrs)) == 4  # half the base, the base (twice), then two decays
