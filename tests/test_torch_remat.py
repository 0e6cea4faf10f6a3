"""``Trainer(remat=True | "blocks")`` against ``remat=False`` and against the
JAX package's ``Trainer(remat=...)``, on the CPU.

- three steps of ResNet18 at full width, 49 px, batch 2 (the parity size of
  ``tests/test_torch_trainer.py``), SGDMomentum with clip and EMA: every
  step's loss and predictions, and the parameters, running stats and EMA
  after it, bit-equal to the same trainer without remat (the recomputation
  runs the same operations on the same inputs) and within the training
  slice's tolerances of the JAX trainer with the same remat (loss rtol
  1e-5; trees rtol 1e-4 / atol 1e-5). The running stats agreeing is the
  proof that each batch's statistics were folded in once: the recomputed
  forward leaves them alone. ``remat=True`` starts from fresh batch norms;
  ``"blocks"`` from batch norms a training forward set, because the JAX
  package's ``jax.checkpoint`` of a block keeps the trace of its first
  step: on a fresh network that trace is the adoption branch, and the
  blocks' running stats then take each later batch's statistics instead of
  their EMA (its loss and parameters are right). So on fresh batch norms
  the port's ``"blocks"`` is held to the JAX trainer without remat;
- the recomputation's kernel calls: 68 ``batch_norm_stats`` and 32
  depthwise forwards a step under ``remat=True`` (the whole forward runs
  twice), 66 and 32 under ``"blocks"`` (the stem's two batch norms are
  outside the blocks);
- ``accumulate_step`` under ``remat="blocks"`` on the narrow net, against
  the JAX trainer's, fresh batch norms (its pre-pass sets them before any
  trace) and batch norms a training forward set."""

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
import dorknet_tpu_torch.ops.conv as conv  # noqa: E402
import dorknet_tpu_torch.ops.norm as norm  # noqa: E402
from dorknet_tpu_torch.models import ResNet18  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402
from dorknet_tpu_torch.regularisers.l2 import l2 as tl2  # noqa: E402
from tests.test_torch_trainer import assert_trees_close, batches, narrow_net  # noqa: E402

LR = 0.05 * (2 / 200)
ARGS = dict(ema_decay=0.9, clip_norm=1.0)


def _leaves_equal(a, b, what):
    import jax

    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb) > 0, what
    for i, (x, y) in enumerate(zip(la, lb, strict=True)):
        np.testing.assert_array_equal(x, y, err_msg="{} leaf {}".format(what, i))


@pytest.mark.parametrize("remat,bn,jax_remat", [(True, "fresh", True), ("blocks", "set", "blocks"),
                                                ("blocks", "fresh", False)])
def test_resnet18_remat_matches_plain_and_jax(remat, bn, jax_remat):
    np.random.seed(0)
    jnet = JaxResNet18("dogs", num_classes=120)
    nets = []
    for _ in range(2):
        np.random.seed(0)
        nets.append(ResNet18("dogs", num_classes=120))
    X, y = batches(1, 4, 2, 49, 120)
    if bn == "set":
        for n in [jnet] + nets:
            n.forward(X[3], y[3])
            n._pending_grads = None
    jtrainer = JaxTrainer(jnet, JaxSGDMomentum(jnet, LR, 0.9), remat=jax_remat, **ARGS)
    plain, rem = (Trainer(n, SGDMomentum(n, LR, 0.9), device="cpu", remat=r, **ARGS)
                  for n, r in zip(nets, (False, remat)))
    for k in range(3):
        jloss, jpreds = jtrainer.step(X[k], y[k])
        loss0, preds0 = plain.step(X[k], y[k])
        loss, preds = rem.step(X[k], y[k])
        assert float(loss) == float(loss0), k
        assert torch.equal(preds, preds0), k
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   err_msg="loss, step {}".format(k))
        np.testing.assert_array_equal(preds.numpy(), np.asarray(jpreds))
        for what, get in (("params", lambda n: n.gather_params()),
                          ("BN running stats", lambda n: n.gather_states())):
            _leaves_equal(get(rem.network), get(plain.network), "{}, step {}".format(what, k))
            assert_trees_close(get(rem.network), get(jnet), "{}, step {}".format(what, k))
        _leaves_equal(rem.ema_params(), plain.ema_params(), "EMA, step {}".format(k))
        assert_trees_close(rem.ema_params(), jtrainer.ema_params(), "EMA, step {}".format(k))


@pytest.mark.parametrize("remat,want", [(False, (34, 16)), (True, (68, 32)),
                                        ("blocks", (66, 32))])
def test_remat_recomputes_the_kernels_calls(monkeypatch, remat, want):
    """Calls of batch_norm_stats and of the depthwise forward in one step
    on set batch norms (the recomputation's calls counted too)."""
    calls = {"stats": 0, "dw": 0}
    real_stats, real_dw = norm.batch_norm_stats, conv.depthwise3x3

    def stats(x):
        calls["stats"] += 1
        return real_stats(x)

    def dw(*args):
        calls["dw"] += 1
        return real_dw(*args)

    monkeypatch.setattr(norm, "batch_norm_stats", stats)
    monkeypatch.setattr(conv, "depthwise3x3", dw)
    np.random.seed(0)
    net = ResNet18("dogs", num_classes=120)
    trainer = Trainer(net, SGDMomentum(net, LR, 0.9), device="cpu", remat=remat)
    X, y = batches(2, 2, 2, 33, 120)
    trainer.step(X[0], y[0])
    calls.update(stats=0, dw=0)
    trainer.step(X[1], y[1])
    assert (calls["stats"], calls["dw"]) == want


@pytest.mark.parametrize("bn", ["fresh", "initialised"])
def test_accumulate_step_under_block_remat_matches_jax(bn):
    np.random.seed(41)
    jnet = narrow_net(jlayers, jl2, JaxNetwork)
    np.random.seed(41)
    net = narrow_net(tlayers, tl2, FeedForwardNetwork)
    jtrainer = JaxTrainer(jnet, JaxSGDMomentum(jnet, 0.05, 0.9), remat="blocks", **ARGS)
    trainer = Trainer(net, SGDMomentum(net, 0.05, 0.9), device="cpu", remat="blocks", **ARGS)
    X, y = batches(42, 5, 4, 17, 10)
    if bn == "initialised":  # a training forward, for the JAX trace's sake (above)
        for n in (jnet, net):
            n.forward(X[4], y[4])
            n._pending_grads = None
    for call in range(2):
        sl = slice(2 * call, 2 * call + 2)
        jloss = jtrainer.accumulate_step(X[sl], y[sl])
        loss = trainer.accumulate_step(X[sl], y[sl])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                                   err_msg="loss, call {}".format(call))
        assert_trees_close(net.gather_params(), jnet.gather_params(),
                           "params, call {}".format(call))
        assert_trees_close(net.gather_states(), jnet.gather_states(),
                           "BN running stats, call {}".format(call))
        assert_trees_close(trainer.ema_params(), jtrainer.ema_params(),
                           "EMA, call {}".format(call))


def test_remat_is_checked():
    net = FeedForwardNetwork("n")
    with pytest.raises(ValueError, match="remat"):
        Trainer(net, SGDMomentum(net, 0.1, 0.9), device="cpu", remat="layers")
