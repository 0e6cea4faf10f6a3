"""The port's InferenceRunner serves a snapshot, as the JAX runner means to
(it gathers params and states at construction and again in ``refresh()``):
built on the same narrow network in both packages, the port's runner keeps
serving the probs both runners served at construction while its source
trains on, and after ``refresh()`` both serve the trained network's probs,
port against JAX (rtol 1e-4 / atol 1e-6, the JAX runner's own test
tolerance). Building a runner neither moves nor modifies the caller's
network.

Between training and ``refresh()`` the JAX runner is not a reference: its
gathered params are the layers' own ``learned_params`` dicts
(``dorknet_tpu/layers/base.py:74-76``), which the JAX trainer's commit
updates in place, so it serves the trained params with the running stats
of construction."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.layers as jlayers  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.network import InferenceRunner as JaxInferenceRunner  # noqa: E402
from dorknet_tpu.network import Trainer as JaxTrainer  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402
from dorknet_tpu.regularisers.l2 import l2 as jl2  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
from dorknet_tpu_torch.network import (FeedForwardNetwork, InferenceRunner,  # noqa: E402
                                       Trainer)
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402
from dorknet_tpu_torch.regularisers.l2 import l2 as tl2  # noqa: E402
from tests.test_torch_trainer import assert_trees_close, batches, narrow_net  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-6)
LR = 0.01


def _trained_pair(steps=1):
    """The narrow net in both packages from one seed, each trained by its
    Trainer for ``steps`` steps (so every batch norm has running stats)."""
    np.random.seed(5)
    jnet = narrow_net(jlayers, jl2, JaxNetwork)
    np.random.seed(5)
    net = narrow_net(tlayers, tl2, FeedForwardNetwork)
    jtrainer = JaxTrainer(jnet, JaxSGDMomentum(jnet, LR, 0.9))
    trainer = Trainer(net, SGDMomentum(net, LR, 0.9), device="cpu")
    X, y = batches(7, 4, 4, 17, 10)
    for k in range(steps):
        jtrainer.step(X[k], y[k])
        trainer.step(X[k], y[k])
    return jnet, net, jtrainer, trainer, X, y


def test_runner_serves_a_snapshot_until_refresh_like_jax():
    jnet, net, jtrainer, trainer, X, y = _trained_pair()
    Xe = np.random.RandomState(11).randn(6, 3, 17, 17).astype(np.float32)
    jrunner = JaxInferenceRunner(jnet, batch_size=4)
    runner = InferenceRunner(net, batch_size=4, device="cpu")
    before_j = np.asarray(jrunner.predict_probs(Xe))
    before = runner.predict_probs(Xe)
    np.testing.assert_allclose(before, before_j, **TOL)
    np.testing.assert_allclose(before, net.forward(Xe, test_mode=True)[1].numpy(), **TOL)

    for k in (1, 2):
        jtrainer.step(X[k], y[k])
        trainer.step(X[k], y[k])
    trained = net.forward(Xe, test_mode=True)[1].numpy()
    assert np.abs(trained - before).max() > 1e-2, "training did not move the probs"
    assert trained.max() < 0.99  # not saturated: the comparisons below mean something
    # the port's runner still serves what both runners served at construction
    stale = runner.predict_probs(Xe)
    np.testing.assert_array_equal(stale, before)
    np.testing.assert_allclose(stale, before_j, **TOL)

    jrunner.refresh()
    runner.refresh()
    after_j = np.asarray(jrunner.predict_probs(Xe))
    after = runner.predict_probs(Xe)
    np.testing.assert_allclose(after, trained, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(after, after_j, **TOL)
    np.testing.assert_allclose(trained, np.asarray(jnet.forward(Xe, None, test_mode=True)[1]),
                               **TOL)


def test_building_a_runner_leaves_the_callers_network_alone():
    """The runner serves its own copy: the caller's parameters and running
    stats are the same tensors, on the same device, with the same values,
    and its last gradients are neither dropped nor copied into the runner."""
    _, net, _, trainer, X, y = _trained_pair()
    net.forward(X[1], y[1])
    net.backward()
    tensors = list(net.parameters()) + list(net.buffers())
    values = [t.detach().clone() for t in tensors]
    grads = net.gather_grads()
    runner = InferenceRunner(net, batch_size=4, device="cpu")
    assert runner.network is not net and runner._source is net
    after = list(net.parameters()) + list(net.buffers())
    assert all(a is b for a, b in zip(after, tensors, strict=True))
    assert all(torch.equal(t, v) and t.device == v.device
               for t, v in zip(after, values, strict=True))
    served = list(runner.network.parameters()) + list(runner.network.buffers())
    assert not {t.data_ptr() for t in served} & {t.data_ptr() for t in tensors}
    assert all(torch.equal(a, b) for a, b in zip(served, values, strict=True))
    assert all(l.grads == {} for l in runner.network.modules() if isinstance(l, tlayers.Layer))
    assert runner.network._pending_grads is None
    assert_trees_close(net.gather_grads(), grads, "the caller's gradients", rtol=0, atol=0)


def test_refresh_copies_in_place_and_fold_bn_still_raises():
    """refresh() writes into the served copy's own tensors (nothing new is
    allocated), including the running stats of batch norms nested in
    residual blocks. fold_bn=True, once refused, now serves the unfolded
    runner's probs within the JAX fold tolerance (rtol 1e-4, atol 1e-5);
    tests/test_torch_fold_bn.py holds its refresh."""
    _, net, _, trainer, X, y = _trained_pair()
    runner = InferenceRunner(net, batch_size=4, device="cpu")
    served = list(runner.network.parameters()) + list(runner.network.buffers())
    ptrs = [t.data_ptr() for t in served]
    trainer.step(X[1], y[1])
    runner.refresh()
    now = list(runner.network.parameters()) + list(runner.network.buffers())
    assert [t.data_ptr() for t in now] == ptrs
    source = list(net.parameters()) + list(net.buffers())
    assert len(source) == len(now) and all(torch.equal(a, b)
                                           for a, b in zip(now, source, strict=True))
    nested = [l for l in runner.network.modules() if isinstance(l, tlayers.BatchNormLayer)]
    assert len(nested) > len([l for l in runner.network.layers
                              if isinstance(l, tlayers.BatchNormLayer)])
    Xe = np.random.RandomState(12).randn(6, 3, 17, 17).astype(np.float32)
    folded = InferenceRunner(net, batch_size=4, device="cpu", fold_bn=True)
    np.testing.assert_allclose(folded.predict_probs(Xe), runner.predict_probs(Xe),
                               rtol=1e-4, atol=1e-5)
