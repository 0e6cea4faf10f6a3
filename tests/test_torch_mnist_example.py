"""The MNIST twin (``dorknet_tpu_torch/examples/MNIST_basic_convnet.py``):
its ``__main__`` via ``runpy`` on the CPU over a tiny npy directory in
``scripts/MNISTprepper.py``'s layout, held to the JAX example's
``__main__`` under one ``np.random.seed``: the same epoch losses (rtol
1e-4: two epochs of fp32 steps in another order) and learning rates. The
test accuracies are not compared: after 8 steps at the recipe's lr 0.01
the probs are near uniform, and fp32 rounding flips some argmaxes (17%
against 25% on the digits). The directory is ``scripts/make_digits_mnist.py``'s real digits
where sklearn and cv2 exist, else synthetic digits with a class signal.
Also the MNIST loader against the JAX package's, bit for bit."""

import os
import runpy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dorknet_tpu.data_loading import MNIST_data_loading as jmnist  # noqa: E402

from dorknet_tpu_torch.data_loading import MNIST_data_loading as tmnist  # noqa: E402
from dorknet_tpu_torch.utils.metrics import read_metrics  # noqa: E402

ENV = {"DORKNET_EPOCHS": "2", "DORKNET_BATCH": "50", "DORKNET_NUM_TRAIN": "200",
       "DORKNET_NUM_VAL": "37", "DORKNET_NUM_TEST": "100", "DORKNET_DEVICE": "cpu"}


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist") / "MNIST_data"
    try:
        from scripts.make_digits_mnist import build

        build(str(d))
    except ImportError:  # no sklearn or cv2: synthetic digits
        rng = np.random.RandomState(0)
        d.mkdir()
        for split, n in (("Train", 300), ("Test", 100)):
            y = rng.randint(0, 10, n).astype(np.uint8)
            x = rng.randint(0, 40, (n, 784)) + 20 * y[:, None]
            np.save(d / "MNIST{}Images.npy".format(split), x.astype(np.uint8))
            np.save(d / "MNIST{}Labels.npy".format(split), y)
    return str(d)


def _run(module, mnist_dir, metrics, monkeypatch):
    for k, v in dict(ENV, DORKNET_MNIST_DIR=mnist_dir, DORKNET_METRICS=metrics).items():
        monkeypatch.setenv(k, v)
    np.random.seed(0)
    runpy.run_module(module, run_name="__main__")
    return read_metrics(metrics)


def test_twin_matches_the_jax_example(mnist_dir, tmp_path, monkeypatch, capsys):
    want = _run("examples.MNIST_basic_convnet", mnist_dir, str(tmp_path / "jax.jsonl"),
                monkeypatch)
    got = _run("dorknet_tpu_torch.examples.MNIST_basic_convnet", mnist_dir,
               str(tmp_path / "port.jsonl"), monkeypatch)
    out = capsys.readouterr().out
    assert "Test acc:" in out and "img/s" in out
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        assert np.isfinite(g["loss"]) and g["train_img_s"] > 0
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        assert 0.0 <= g["test_acc"] <= 1.0 and g["lr"] == w["lr"]


def test_twin_needs_its_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("DORKNET_MNIST_DIR", str(tmp_path / "missing"))
    with pytest.raises(SystemExit, match="not found"):
        runpy.run_module("dorknet_tpu_torch.examples.MNIST_basic_convnet", run_name="__main__")


def test_loader_matches_jax(mnist_dir):
    got = tmnist.get_MNIST_data(num_training=200, num_validation=37, num_test=100,
                                mnist_dir=mnist_dir)
    want = jmnist.get_MNIST_data(num_training=200, num_validation=37, num_test=100,
                                 mnist_dir=mnist_dir)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    X, y = got[0], got[1]
    np.random.seed(3)
    batches = list(tmnist.epoch_image_generator(X, y, 64))
    np.random.seed(3)
    jbatches = list(jmnist.epoch_image_generator(X, y, 64))
    assert len(batches) == len(jbatches) == 3
    for a, b in zip(batches, jbatches):
        assert a[0].shape == (64, 1, 28, 28)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    assert os.path.isdir(mnist_dir)
