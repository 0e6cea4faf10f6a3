"""The port's threaded loader over a packed directory against the JAX
package's ``ImageDataLoader`` on the CPU: under one ``np.random.seed`` both
yield the same batches (center and random crops, the uint8 canvases of
``emit_hwc_uint8``, host mixup, a data shard, after a shuffle), its
``shuffle_indices`` and ``stop_thread`` end under a time limit, and
``FeedForwardNetwork.test`` over it gives the JAX package's accuracy on
the same weights."""

import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.layers as jlayers  # noqa: E402
from dorknet_tpu.data_loading import ImageDataLoader as JaxLoader  # noqa: E402
from dorknet_tpu.data_loading import ImagePreprocessor as JaxPreprocessor  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.network import Trainer as JaxTrainer  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402
from dorknet_tpu.regularisers.l2 import l2 as jl2  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
from dorknet_tpu_torch.data_loading import (ImageDataLoader, ImagePreprocessor,  # noqa: E402
                                            write_packed_arrays)
from dorknet_tpu_torch.data_loading.image_data_loader import mixup_pair  # noqa: E402
from dorknet_tpu_torch.network import FeedForwardNetwork  # noqa: E402
from dorknet_tpu_torch.regularisers.l2 import l2 as tl2  # noqa: E402
from tests.test_torch_trainer import batches, narrow_net  # noqa: E402

OUT = (24, 24)  # precrop 30 x 30
CLASSES = ("akita", "beagle", "corgi")
LIMIT_S = 20.0


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """3 classes of 7, 5 and 6 random 30 x 30 canvases."""
    labels = np.repeat(np.arange(3), (7, 5, 6))
    images = np.random.RandomState(5).randint(0, 256, (len(labels), 30, 30, 3)).astype(np.uint8)
    out = str(tmp_path_factory.mktemp("pack") / "packed")
    write_packed_arrays(out, images, labels, CLASSES)
    return out


CASES = {
    "center": dict(crop_mode="center", kw=dict()),
    "random": dict(crop_mode="random", kw=dict(class_balance=False)),
    "emit_hwc_uint8": dict(crop_mode="random", kw=dict(class_balance=False, emit_hwc_uint8=True),
                           shuffle=True),
    "mixup": dict(crop_mode="center", kw=dict(class_balance=False, mixup_range_tuple=(0, 0.3))),
    "shard": dict(crop_mode="center", kw=dict(data_shard=(1, 2))),
}


def pulled(loader_cls, preprocessor_cls, pack, case, n, seed=11):
    """n batches of a loader built after np.random.seed(seed), with a
    shuffle first where the case asks (only where the producer draws no
    random numbers itself, so the shuffle's draw is the same)."""
    np.random.seed(seed)
    loader = loader_cls(pack, 4, preprocessor_cls(OUT, crop_mode=case["crop_mode"]),
                        num_workers=1, **case["kw"])
    try:
        if case.get("shuffle"):
            loader.shuffle_indices()
        return list(loader.pull_batch(n))
    finally:
        loader.stop_thread()


@pytest.mark.parametrize("name", sorted(CASES))
def test_batches_equal_the_jax_loaders(name, pack):
    case = CASES[name]
    want = pulled(JaxLoader, JaxPreprocessor, pack, case, 6)
    got = pulled(ImageDataLoader, ImagePreprocessor, pack, case, 6)
    for k, ((X, y, oh), (jX, jy, joh)) in enumerate(zip(got, want, strict=True)):
        assert X.dtype == jX.dtype and X.shape == jX.shape, k
        np.testing.assert_array_equal(X, jX, err_msg="batch {}".format(k))
        assert list(y) == list(jy)
        np.testing.assert_array_equal(oh, joh)
    shape = (4, 30, 30, 3) if name == "emit_hwc_uint8" else (4, 3, 24, 24)
    assert got[0][0].shape == shape


def test_host_mixup_pair():
    rng = np.random.RandomState(0)
    Xa, Xb = rng.randn(2, 3, 4).astype(np.float32), rng.randn(2, 3, 4).astype(np.float32)
    ya, yb = np.eye(3, dtype=np.float32)[[0, 1]], np.eye(3, dtype=np.float32)[[2, 2]]
    (X1, y1), (X2, y2) = mixup_pair(Xa, ya, Xb, yb, 0.25)
    np.testing.assert_array_equal(X1, (0.25 * Xb + 0.75 * Xa).astype(np.float32))
    np.testing.assert_array_equal(y2, (0.25 * ya + 0.75 * yb).astype(np.float32))
    assert X1.dtype == X2.dtype == np.float32


def test_shuffle_and_stop_end_in_time(pack):
    """shuffle_indices while the producer is blocked on a full queue, pulls
    between shuffles, and stop_thread: each ends well inside the limit and
    the producer is gone."""
    loader = ImageDataLoader(pack, 4, ImagePreprocessor(OUT, crop_mode="random"),
                             num_workers=2, class_balance=False)
    t0 = time.perf_counter()
    deadline = t0 + 5.0
    while not loader.batch_queue.full() and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert loader.batch_queue.full()
    for _ in range(3):
        loader.shuffle_indices()
        batch = next(loader.pull_batch(1))
        assert batch[0].shape == (4, 3, 24, 24)
    loader.stop_thread()
    assert not loader.queue_thread.is_alive()
    assert time.perf_counter() - t0 < LIMIT_S
    # a stop while the producer is blocked on a full queue
    loader = ImageDataLoader(pack, 4, ImagePreprocessor(OUT, crop_mode="center"))
    while not loader.batch_queue.full() and time.perf_counter() < deadline + 5.0:
        time.sleep(0.01)
    t1 = time.perf_counter()
    loader.stop_thread()
    assert not loader.queue_thread.is_alive() and time.perf_counter() - t1 < LIMIT_S


def test_network_test_matches_jax(pack):
    """The same weights and running stats in both packages, each package's
    network.test over its own loader from the same seed: the same
    accuracy."""
    np.random.seed(3)
    jnet = narrow_net(jlayers, jl2, JaxNetwork)
    np.random.seed(3)
    net = narrow_net(tlayers, tl2, FeedForwardNetwork)
    X, y = batches(8, 1, 8, 24, 10)
    JaxTrainer(jnet, JaxSGDMomentum(jnet, 0.05, 0.9)).step(X[0], y[0])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    net.load_numpy_params(to_np(jnet.gather_params()), to_np(jnet.gather_states()))
    acc = {}
    for name, network, loader_cls, pp_cls in (("jax", jnet, JaxLoader, JaxPreprocessor),
                                              ("port", net, ImageDataLoader, ImagePreprocessor)):
        np.random.seed(4)
        loader = loader_cls(pack, 6, pp_cls(OUT, crop_mode="center"), num_workers=1)
        try:
            acc[name] = network.test(loader.pull_batch(3), 6, 18)
        finally:
            loader.stop_thread()
    assert acc["port"] == acc["jax"]
    assert 0.0 <= acc["port"] <= 1.0
