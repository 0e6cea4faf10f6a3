"""The port's torch-native checkpoint (``utils/torch_io.py``) on the CPU: a
round trip, a restored trainer's next step bit-equal to the original's,
the restore in place (every ``data_ptr()`` kept, as a captured step needs),
the cache marked as the trainer's so momentum survives the first step, the
EMA, the branches for a file without a cache or without an EMA, an async
save that holds the state of its call, and a port trainer restored
mid-run against the JAX trainer from the same seed (the tolerances of
``tests/test_torch_trainer.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.layers as jlayers  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.network import Trainer as JaxTrainer  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402
from dorknet_tpu.regularisers.l2 import l2 as jl2  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
from dorknet_tpu_torch.layers import BatchNormLayer  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import RMSProp, SGDMomentum  # noqa: E402
from dorknet_tpu_torch.regularisers.l2 import l2 as tl2  # noqa: E402
from dorknet_tpu_torch.utils import torch_io  # noqa: E402
from tests.test_torch_trainer import assert_trees_close, batches, narrow_net  # noqa: E402

LR = 0.05


def net_of(seed):
    np.random.seed(seed)
    return narrow_net(tlayers, tl2, FeedForwardNetwork)


def trainer_of(net, ema_decay=None, optimiser=SGDMomentum):
    opt = optimiser(net, LR, 0.9)
    return Trainer(net, opt, ema_decay=ema_decay, device="cpu")


def data(steps=6):
    return batches(21, steps, 8, 12, 10)


def state(trainer):
    """Every parameter, running stat, optimiser-cache and EMA tensor."""
    stats = [b for m in trainer.network.modules() if isinstance(m, BatchNormLayer)
             for b in (m.running_mean, m.running_std)]
    return (list(trainer.network.parameters()) + stats + list(trainer._cache or [])
            + list(trainer._ema or []))


def assert_equal_state(a, b):
    sa, sb = state(a), state(b)
    assert len(sa) == len(sb) > 0
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("optimiser", [SGDMomentum, RMSProp])
def test_restored_trainer_takes_the_same_next_step(optimiser, tmp_path):
    X, y = data()
    trainer = trainer_of(net_of(1), ema_decay=0.9, optimiser=optimiser)
    for k in range(3):
        trainer.step(X[k], y[k])
    path = str(tmp_path / "ck.pt")
    assert torch_io.save_checkpoint(path, trainer.network, trainer) == path
    restored = trainer_of(net_of(2), ema_decay=0.9, optimiser=optimiser)  # other weights
    torch_io.load_checkpoint(path, restored.network, restored)
    assert restored._cache_owner is restored.optimiser
    assert_equal_state(restored, trainer)
    np.testing.assert_array_equal(restored.network.forward(X[0], test_mode=True)[1].numpy(),
                                  trainer.network.forward(X[0], test_mode=True)[1].numpy())
    for k in range(3, 5):
        la, pa = trainer.step(X[k], y[k])
        lb, pb = restored.step(X[k], y[k])
        assert torch.equal(la, lb) and torch.equal(pa, pb)
        assert_equal_state(restored, trainer)


def test_load_is_in_place(tmp_path):
    """Every live tensor keeps its address, as the CUDA graph of a captured
    step reads them by address."""
    X, y = data()
    trainer = trainer_of(net_of(1), ema_decay=0.9)
    for k in range(2):
        trainer.step(X[k], y[k])
    path = str(tmp_path / "ck.pt")
    torch_io.save_checkpoint(path, trainer.network, trainer)
    want = [t.clone() for t in state(trainer)]
    trainer.step(X[2], y[2])
    ptrs = [t.data_ptr() for t in state(trainer)]
    key = trainer._signature()
    torch_io.load_checkpoint(path, trainer.network, trainer)
    assert [t.data_ptr() for t in state(trainer)] == ptrs
    assert trainer._signature() == key
    for got, w in zip(state(trainer), want, strict=True):
        assert torch.equal(got, w)


def test_restored_momentum_survives_the_first_step(tmp_path):
    """The cache is marked as this trainer's optimiser's: its first step
    uses the restored velocities, not zeros (the parameters after it say
    so)."""
    X, y = data()
    trainer = trainer_of(net_of(1))
    for k in range(3):
        trainer.step(X[k], y[k])
    path = str(tmp_path / "ck.pt")
    torch_io.save_checkpoint(path, trainer.network, trainer)
    fresh = trainer_of(net_of(2))
    assert fresh._cache is None
    torch_io.load_checkpoint(path, fresh.network, fresh)
    assert any(c.abs().max() > 0 for c in fresh._cache)
    trainer.step(X[3], y[3])
    fresh.step(X[3], y[3])
    for a, b in zip(trainer.network.parameters(), fresh.network.parameters()):
        assert torch.equal(a, b)


def test_ema_round_trip_and_a_file_without_ema(tmp_path):
    X, y = data()
    trainer = trainer_of(net_of(1), ema_decay=0.9)
    for k in range(3):
        trainer.step(X[k], y[k])
    path = str(tmp_path / "ema.pt")
    torch_io.save_checkpoint(path, trainer.network, trainer)
    other = trainer_of(net_of(2), ema_decay=0.9)
    torch_io.load_checkpoint(path, other.network, other)
    assert all(torch.equal(a, b) for a, b in zip(other._ema, trainer._ema, strict=True))
    # a trainer without an EMA ignores the file's shadow
    plain = trainer_of(net_of(3))
    torch_io.load_checkpoint(path, plain.network, plain)
    assert plain._ema is None and plain._cache is not None

    # a file without an EMA into an EMA trainer: the cache is restored, the
    # shadow starts from the restored parameters at the next step
    no_ema = trainer_of(net_of(4))
    no_ema.step(X[0], y[0])
    p2 = str(tmp_path / "plain.pt")
    torch_io.save_checkpoint(p2, no_ema.network, no_ema)
    ema_trainer = trainer_of(net_of(5), ema_decay=0.9)
    torch_io.load_checkpoint(p2, ema_trainer.network, ema_trainer)
    assert ema_trainer._ema is None and ema_trainer._cache is not None
    params = [p.detach().clone() for p in ema_trainer.network.parameters()]
    ema_trainer.step(X[1], y[1])
    for e, p0, p1 in zip(ema_trainer._ema, params, ema_trainer.network.parameters()):
        torch.testing.assert_close(e, 0.9 * p0 + 0.1 * p1.detach(), rtol=0, atol=1e-6)


def test_files_without_a_cache(tmp_path):
    """A network-only file leaves a warm trainer's cache as it is; a file
    with a cache restores into a trainer that has none yet, and into no
    trainer at all."""
    X, y = data()
    net_only = net_of(1)
    trainer_of(net_only).step(X[0], y[0])  # sets the batch norms
    p1 = str(tmp_path / "net.pt")
    torch_io.save_checkpoint(p1, net_only)
    warm = trainer_of(net_of(2))
    warm.step(X[0], y[0])
    warm.step(X[1], y[1])
    cache = [c.clone() for c in warm._cache]
    torch_io.load_checkpoint(p1, warm.network, warm)
    assert all(torch.equal(a, b) for a, b in zip(warm._cache, cache))
    assert all(torch.equal(a, b) for a, b in zip(warm.network.parameters(),
                                                 net_only.parameters()))
    p2 = str(tmp_path / "with_cache.pt")
    torch_io.save_checkpoint(p2, warm.network, warm)
    torch_io.load_checkpoint(p2, net_of(3))
    with pytest.raises(ValueError, match="layers"):
        empty = FeedForwardNetwork("empty")
        torch_io.load_checkpoint(p2, empty)


def test_batch_norm_state_branches(tmp_path):
    """A file written with unset batch norms leaves the network's statistics
    as they are; a file that sets them sets a fresh network's, which
    changes the trainer's graph key (the next captured step captures anew)."""
    X, y = data()
    fresh = net_of(1)
    p0 = str(tmp_path / "unset.pt")
    torch_io.save_checkpoint(p0, fresh)
    trained = trainer_of(net_of(2))
    trained.step(X[0], y[0])
    stats = [t.clone() for t in state(trained)]
    torch_io.load_checkpoint(p0, trained.network)
    assert all(l.bn_initialized() for l in trained.network.layers)
    for a, b in zip(list(trained.network.parameters()), list(fresh.parameters())):
        assert torch.equal(a, b)
    n_params = len(list(fresh.parameters()))
    for a, b in zip(state(trained)[n_params:], stats[n_params:]):
        assert torch.equal(a, b)

    p1 = str(tmp_path / "set.pt")
    torch_io.save_checkpoint(p1, trained.network, trained)
    target = trainer_of(net_of(3))
    key = target._signature()
    torch_io.load_checkpoint(p1, target.network, target)
    assert all(l.bn_initialized() for l in target.network.layers)
    assert target._signature() != key
    assert_equal_state(target, trained)


def test_async_save_holds_the_state_of_its_call(tmp_path):
    X, y = data()
    trainer = trainer_of(net_of(1), ema_decay=0.9)
    trainer.step(X[0], y[0])
    at_save = [t.clone() for t in state(trainer)]
    path = str(tmp_path / "async.pt")
    ckptr = torch_io.save_checkpoint_async(path, trainer.network, trainer)
    for k in range(1, 3):
        trainer.step(X[k], y[k])  # changes every tensor in place
    ckptr.wait_until_finished()
    assert any(not torch.equal(a, b) for a, b in zip(state(trainer), at_save))
    restored = trainer_of(net_of(2), ema_decay=0.9)
    torch_io.load_checkpoint(path, restored.network, restored)
    for got, want in zip(state(restored), at_save, strict=True):
        assert torch.equal(got, want)
    # a second save waits for the first; the last one is on disk after the wait
    torch_io.save_checkpoint_async(path, trainer.network, trainer)
    torch_io.save_checkpoint_async(path, trainer.network, trainer).wait_until_finished()
    torch_io.load_checkpoint(path, restored.network, restored)
    assert_equal_state(restored, trainer)


def test_restored_mid_run_matches_the_jax_trainer(tmp_path):
    """The JAX trainer takes four steps; the port takes two, saves, and a
    new port network and trainer restored from the file take the last two.
    Loss, parameters, running stats and EMA agree after each."""
    X, y = data(4)
    np.random.seed(1)
    jnet = narrow_net(jlayers, jl2, JaxNetwork)
    jtrainer = JaxTrainer(jnet, JaxSGDMomentum(jnet, LR, 0.9), ema_decay=0.9)
    trainer = trainer_of(net_of(1), ema_decay=0.9)
    for k in range(2):
        jtrainer.step(X[k], y[k])
        trainer.step(X[k], y[k])
    path = str(tmp_path / "mid.pt")
    torch_io.save_checkpoint(path, trainer.network, trainer)
    restored = trainer_of(net_of(7), ema_decay=0.9)
    torch_io.load_checkpoint(path, restored.network, restored)
    for k in range(2, 4):
        jloss, _ = jtrainer.step(X[k], y[k])
        loss, _ = restored.step(X[k], y[k])
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert_trees_close(restored.network.gather_params(), jnet.gather_params(), "params")
        assert_trees_close(restored.network.gather_states(), jnet.gather_states(), "states")
        assert_trees_close(restored.ema_params(), jtrainer.ema_params(), "EMA")
