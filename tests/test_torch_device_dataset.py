"""The device-resident input path against the JAX package on the CPU: packed
directories read by both packages, the index samplers of the two
``DeviceResidentDataset``s, the chunked upload, and
``Trainer.step_augmented_indexed`` (within the port, and against JAX's)."""

import json
import os

import cv2
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dorknet_tpu.layers as jlayers  # noqa: E402
from dorknet_tpu.data_loading import DeviceResidentDataset as JaxDataset  # noqa: E402
from dorknet_tpu.data_loading.packed_dataset import PackedDataset as JaxPacked  # noqa: E402
from dorknet_tpu.data_loading.packed_dataset import write_packed_dataset  # noqa: E402
from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402
from dorknet_tpu.network import Trainer as JaxTrainer  # noqa: E402
from dorknet_tpu.optimisers import SGDMomentum as JaxSGDMomentum  # noqa: E402

import dorknet_tpu_torch.layers as tlayers  # noqa: E402
from dorknet_tpu_torch.data_loading import (DeviceResidentDataset, ImageDataLoader,  # noqa: E402
                                            ImagePreprocessor, PackedDataset, default_precrop,
                                            device_prefetch, fits_in_hbm, is_packed_dir,
                                            stack_batches, write_packed_arrays)
from dorknet_tpu_torch.network import FeedForwardNetwork, Trainer  # noqa: E402
from dorknet_tpu_torch.optimisers import SGDMomentum  # noqa: E402
from tests.test_torch_aug_trainer import AUG, PIPELINE_CFG, small_net  # noqa: E402
from tests.test_torch_augment import (inject_draws, jax_pipeline_draws,  # noqa: E402
                                      structured_images)
from tests.test_torch_trainer import assert_trees_close  # noqa: E402

PRECROP = 30
OUT = (24, 24)
CLASSES = ("akita", "beagle", "corgi")


@pytest.fixture
def numpy_pack(tmp_path):
    """A packed directory written with numpy: 3 classes of 5, 4 and 3
    images, 30x30 canvases."""
    counts = (5, 4, 3)
    labels = np.repeat(np.arange(3), counts)
    images = structured_images(11, len(labels), PRECROP, PRECROP)
    out = str(tmp_path / "packed")
    assert write_packed_arrays(out, images, labels, CLASSES) == 12
    return out


@pytest.fixture
def cv2_pack(tmp_path):
    """A packed directory written by the JAX package from PNGs (cv2)."""
    rng = np.random.RandomState(7)
    src = tmp_path / "src"
    for c in CLASSES:
        d = src / c / "images"
        d.mkdir(parents=True)
        for i in range(4):
            cv2.imwrite(str(d / f"{i}.png"), rng.randint(0, 255, (48, 56, 3), dtype=np.uint8))
    out = str(tmp_path / "packed_cv2")
    assert write_packed_dataset(str(src), out, (PRECROP, PRECROP)) == 12
    return out


def assert_same_pack(a, b):
    np.testing.assert_array_equal(np.asarray(a.images), np.asarray(b.images))
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.labels.dtype == b.labels.dtype == np.int32
    assert a.paths == b.paths and a.class_names == b.class_names
    assert a.per_class_rows == b.per_class_rows and tuple(a.precrop) == tuple(b.precrop)


def test_packs_read_by_both_packages(numpy_pack, cv2_pack):
    for path in (numpy_pack, cv2_pack):
        assert is_packed_dir(path)
        assert_same_pack(PackedDataset(path), JaxPacked(path))
    p = PackedDataset(numpy_pack)
    np.testing.assert_array_equal(p.gather([3, 0]), np.asarray(p.images)[[3, 0]])
    with open(os.path.join(numpy_pack, "packed_meta.json")) as f:
        meta = json.load(f)
    meta["format"] = "other"
    with open(os.path.join(numpy_pack, "packed_meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="not a dorknet-packed-v1"):
        PackedDataset(numpy_pack)
    with pytest.raises(ValueError, match="pack order"):
        write_packed_arrays(numpy_pack + "_bad", np.zeros((2, 4, 4, 3), np.uint8), [1, 0],
                            CLASSES)


@pytest.mark.parametrize("balance,shard", [
    (True, None), (False, None), (True, (0, 2)), (False, (1, 2)), (False, (2, 3))])
def test_samplers_draw_the_same_rows(numpy_pack, balance, shard):
    """Under the same numpy seed the two packages' next_indices agree,
    before and after shuffle_indices."""
    jdd = JaxDataset(numpy_pack, batch_size=4, class_balance=balance, data_shard=shard)
    dd = DeviceResidentDataset(numpy_pack, batch_size=4, class_balance=balance,
                               data_shard=shard, device="cpu")
    for epoch in range(3):
        for _ in range(4):
            want, got = jdd.next_indices(), dd.next_indices()
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)
        np.random.seed(30 + epoch)
        jdd.shuffle_indices()
        np.random.seed(30 + epoch)
        dd.shuffle_indices()
    assert [next(dd.pull_indices(1)).tolist()] == [jdd.next_indices().tolist()]


def test_data_shards_split_the_dataset(numpy_pack):
    dds = [DeviceResidentDataset(numpy_pack, 2, class_balance=False, data_shard=(i, 2),
                                 device="cpu") for i in range(2)]
    rows = [set(np.concatenate([d.next_indices() for _ in range(4)]).tolist()) for d in dds]
    assert rows[0].isdisjoint(rows[1]) and rows[0] | rows[1] == set(range(12))
    with pytest.raises(ValueError, match="data_shard"):
        DeviceResidentDataset(numpy_pack, 2, data_shard=(2, 2), device="cpu")
    with pytest.raises(ValueError, match="have no images"):
        # the third class has 3 images, so shard 3 of 4 holds none of it
        DeviceResidentDataset(numpy_pack, 2, class_balance=True, data_shard=(3, 4),
                              device="cpu")


def test_upload_reassembles_the_arrays(numpy_pack):
    """Chunks of 5 rows (three chunks, the staging buffers reused) land
    byte-exact in the one preallocated tensor."""
    dd = DeviceResidentDataset(numpy_pack, batch_size=4,
                               chunk_bytes=5 * PRECROP * PRECROP * 3, device="cpu")
    assert len(dd) == 12 and dd.num_classes == 3 and dd.class_names == list(CLASSES)
    assert dd.images.dtype == torch.uint8 and dd.labels.dtype == torch.int32
    np.testing.assert_array_equal(dd.images.numpy(), np.asarray(dd.packed.images))
    np.testing.assert_array_equal(dd.labels.numpy(), dd.packed.labels)
    assert dd.packed is dd._sampler.packed and dd._row_of is dd._sampler._packed_row


def test_expect_precrop_guard(numpy_pack):
    DeviceResidentDataset(numpy_pack, 4, expect_precrop=(PRECROP, PRECROP), device="cpu")
    with pytest.raises(ValueError, match="repack"):
        DeviceResidentDataset(numpy_pack, 4, expect_precrop=(PRECROP + 8, PRECROP + 8),
                              device="cpu")


def test_fits_in_hbm_defaults_to_half_the_card(numpy_pack, monkeypatch):
    packed = PackedDataset(numpy_pack)
    nbytes = packed.images.nbytes

    class Props:
        total_memory = 2 * nbytes

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props)
    assert fits_in_hbm(packed)
    Props.total_memory = 2 * nbytes - 2
    assert not fits_in_hbm(packed)
    assert fits_in_hbm(packed, budget_bytes=nbytes) and not fits_in_hbm(packed, 100)


def test_unported_loader_modes_raise(numpy_pack, tmp_path, monkeypatch):
    # the modes that resize with cv2 (no crop mode, the host augmenter) or
    # decode a JPEG tree
    with pytest.raises(NotImplementedError, match="A5"):
        ImageDataLoader(numpy_pack, 4, ImagePreprocessor((24, 24)))
    with pytest.raises(NotImplementedError, match="A5"):
        ImagePreprocessor((24, 24), crop_mode="random", image_augmenter=object())
    with pytest.raises(NotImplementedError, match="not a packed directory"):
        ImageDataLoader(str(tmp_path), 4, ImagePreprocessor((24, 24)), start_thread=False)
    assert default_precrop((225, 225)) == (281, 281)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceResidentDataset(numpy_pack, 4)


def test_prefetch_and_stack():
    batches = [(np.full((2, 3), i, np.float64), [i], np.arange(2, dtype=np.int32) + i)
               for i in range(5)]
    got = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(got) == 5
    for i, (x, ys, z) in enumerate(got):
        assert x.dtype == torch.float32 and float(x[0, 0]) == i and ys == [i]
        assert torch.equal(z, torch.tensor([i, i + 1], dtype=torch.int32))
    stacked = list(stack_batches(iter(got), 2))
    assert len(stacked) == 2  # the fifth batch is dropped
    x, ys, z = stacked[1]
    assert x.shape == (2, 2, 3) and ys == [[2], [3]] and z.shape == (2, 2)
    assert np.stack(next(stack_batches(iter(batches), 2))[0]).shape == (2, 2, 3)


def test_step_augmented_indexed_equals_direct(numpy_pack):
    """Same generator seed, same rows: the indexed step equals
    step_augmented on images[rows] with the one-hot labels, bit for bit."""
    dd = DeviceResidentDataset(numpy_pack, batch_size=6, class_balance=False, device="cpu")
    nets = [small_net(tlayers, FeedForwardNetwork) for _ in range(2)]
    ta, tb = (Trainer(n, SGDMomentum(n, 0.05, 0.9), device="cpu") for n in nets)
    ga, gb = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    for _ in range(3):
        rows = dd.next_indices()
        la, pa = ta.step_augmented_indexed(ga, dd.images, dd.labels, rows, OUT,
                                           dd.num_classes, **AUG)
        X = dd.packed.gather(rows)
        oh = np.eye(dd.num_classes, dtype=np.float32)[dd.packed.labels[rows]]
        lb, pb = tb.step_augmented(gb, X, oh, OUT, **AUG)
        assert float(la) == float(lb) and torch.equal(pa, pb)
    for p, q in zip(nets[0].parameters(), nets[1].parameters(), strict=True):
        assert torch.equal(p, q)


@pytest.mark.parametrize("rows", [[0, 12], np.array([-1, 3]), torch.tensor([5, 12])],
                         ids=["list", "numpy_negative", "cpu_tensor"])
def test_step_augmented_indexed_checks_host_rows(numpy_pack, rows):
    """Host rows, a CPU tensor among them, are checked against the dataset's
    length before the gather, and the step leaves the network untouched."""
    dd = DeviceResidentDataset(numpy_pack, batch_size=6, class_balance=False, device="cpu")
    net = small_net(tlayers, FeedForwardNetwork)
    before = [p.detach().clone() for p in net.parameters()]
    tr = Trainer(net, SGDMomentum(net, 0.05, 0.9), device="cpu")
    with pytest.raises(IndexError, match=r"rows must lie in \[0, 12\)"):
        tr.step_augmented_indexed(torch.Generator().manual_seed(3), dd.images, dd.labels, rows,
                                  OUT, dd.num_classes, **AUG)
    for p, q in zip(net.parameters(), before, strict=True):
        assert torch.equal(p, q)


def test_step_augmented_indexed_matches_jax(numpy_pack, monkeypatch):
    """The JAX package's indexed step and the port's from the same fresh
    weights, rows and draws: loss 1e-4 relative, parameters and running
    stats 1e-4 relative / 1e-5 absolute, after each of three steps."""
    jdd = JaxDataset(numpy_pack, batch_size=6, class_balance=False)
    dd = DeviceResidentDataset(numpy_pack, batch_size=6, class_balance=False, device="cpu")
    jnet, net = small_net(jlayers, JaxNetwork), small_net(tlayers, FeedForwardNetwork)
    jtr = JaxTrainer(jnet, JaxSGDMomentum(jnet, 0.05, 0.9))
    tr = Trainer(net, SGDMomentum(net, 0.05, 0.9), device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(17), 3)
    inject_draws(monkeypatch, [jax_pipeline_draws(k, 6, (PRECROP, PRECROP), OUT, PIPELINE_CFG,
                                                  AUG["mixup"]) for k in keys])
    for k in keys:
        rows = jdd.next_indices()
        np.testing.assert_array_equal(dd.next_indices(), rows)
        jloss, jpreds = jtr.step_augmented_indexed(k, jdd.images, jdd.labels, rows, OUT,
                                                   jdd.num_classes, **AUG)
        loss, preds = tr.step_augmented_indexed(torch.Generator(), dd.images, dd.labels, rows,
                                                OUT, dd.num_classes, **AUG)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
        np.testing.assert_array_equal(preds.numpy(), np.asarray(jpreds))
        assert_trees_close(net.gather_params(), jnet.gather_params(), "params")
        assert_trees_close(net.gather_states(), jnet.gather_states(), "BN running stats")
