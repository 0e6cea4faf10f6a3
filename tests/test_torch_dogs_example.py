"""The twin of the flagship training script
(``dorknet_tpu_torch/examples/imagenet_dogs_225_resnet_18_depsep.py``): its
``__main__`` end to end on the CPU, ResNet18 at 40 px, batch 16, one epoch
of 2 steps, then a restart from that epoch's checkpoint for one more, in
each checkpoint format and on both input paths (the resident dataset, the
streaming loader, and the fall-back from the first to the second over the
device-memory budget), over synthetic packed ``train_img`` and ``val_img``
directories of the 120 classes."""

import logging
import math
import os
import runpy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dorknet_tpu.network import FeedForwardNetwork as JaxNetwork  # noqa: E402

from dorknet_tpu_torch.data_loading import write_packed_arrays  # noqa: E402
from dorknet_tpu_torch.models import ResNet18  # noqa: E402
from dorknet_tpu_torch.utils import torch_io  # noqa: E402
from dorknet_tpu_torch.utils.metrics import read_metrics  # noqa: E402

SCRIPT = "dorknet_tpu_torch.examples.imagenet_dogs_225_resnet_18_depsep"
N_CLASSES = 120  # ResNet18's classifier width
IMG = 40


@pytest.fixture(scope="module")
def dogs_data(tmp_path_factory):
    """Packed train (2 a class) and val (1 a class) sets of 50 x 50
    canvases, the precrop of 40 px."""
    root = tmp_path_factory.mktemp("dogs") / "data"
    rng = np.random.RandomState(0)
    for split, n in (("train_img", 2), ("val_img", 1)):
        labels = np.repeat(np.arange(N_CLASSES), n)
        images = rng.randint(0, 256, (len(labels), 50, 50, 3)).astype(np.uint8)
        write_packed_arrays(str(root / "ImageNet2012" / "ILSVRC2012_dogs" / split), images,
                            labels, ["class_{:03d}".format(c) for c in range(N_CLASSES)])
    return str(root)


@pytest.fixture
def run_script(dogs_data, tmp_path, monkeypatch):
    """run(**env) executes the script's __main__ in tmp_path with the tiny
    configuration and the extra DORKNET_* variables given."""
    base = {"DORKNET_DATA": dogs_data, "DORKNET_BATCH": "16", "DORKNET_IMAGE": str(IMG),
            "DORKNET_TRAIN_SIZE": "64",  # 2 steps of 2 x 16 mixed images
            "DORKNET_VAL_SIZE": "32", "DORKNET_WORKERS": "2", "DORKNET_DEVICE": "cpu",
            "DORKNET_EMA": "0.999", "DORKNET_EXPERIMENT": "TinyDogs"}
    monkeypatch.chdir(tmp_path)
    handlers = logging.getLogger().handlers[:]

    def run(**env):
        for k in ("DORKNET_RESTART_CKPT", "DORKNET_START_EPOCH", "DORKNET_DEVICE_RESIDENT",
                  "DORKNET_ON_DEVICE_AUGMENT", "DORKNET_HBM_BUDGET"):
            monkeypatch.delenv(k, raising=False)
        for k, v in dict(base, **env).items():
            monkeypatch.setenv(k, v)
        runpy.run_module(SCRIPT, run_name="__main__")

    yield run
    for h in logging.getLogger().handlers[:]:
        if h not in handlers:
            logging.getLogger().removeHandler(h)
            h.close()


RESIDENT = {"DORKNET_DEVICE_RESIDENT": "1"}
STREAMING = {"DORKNET_ON_DEVICE_AUGMENT": "1"}
# a resident set over the device-memory budget falls back to streaming
OVER_BUDGET = dict(RESIDENT, DORKNET_HBM_BUDGET="1")


@pytest.mark.parametrize("fmt, path, resident", [("torch", RESIDENT, True),
                                                 ("h5", RESIDENT, True),
                                                 ("torch", STREAMING, False),
                                                 ("h5", OVER_BUDGET, False)])
def test_train_then_restart(run_script, tmp_path, fmt, path, resident):
    run_script(DORKNET_CKPT_FORMAT=fmt, DORKNET_EPOCHS="2", **path)
    exp = tmp_path / "TinyDogs"
    ckpt = [f for f in os.listdir(exp) if f.startswith("epoch_1_testacc_")]
    assert len(ckpt) == 1 and ckpt[0].endswith("." + ("pt" if fmt == "torch" else "h5"))
    assert (exp / "epoch_1_ema.{}".format("pt" if fmt == "torch" else "h5")).exists()
    recs = read_metrics(str(tmp_path / "logging" / "TinyDogs.metrics.jsonl"))
    steps = [r for r in recs if "loss" in r]
    assert steps and all(math.isfinite(r["loss"]) for r in steps)
    assert all(r["device_resident"] is resident and r["on_device_augment"] is not resident
               for r in recs)
    (epoch,) = [r for r in recs if "test_acc" in r]
    assert 0.0 <= epoch["test_acc"] <= 1.0 and epoch["train_img_s"] > 0

    if fmt == "h5":
        # the JAX package loads the twin's checkpoint
        jnet = JaxNetwork("")
        jnet.load_network_from_json_and_h5(str(exp / "TinyDogs.json"), str(exp / ckpt[0]))
        assert len(jnet.layers) == len(ResNet18("x").layers)
    else:
        net = ResNet18("x")
        torch_io.load_checkpoint(str(exp / ckpt[0]), net)
        assert all(l.bn_initialized() for l in net.layers)

    run_script(DORKNET_CKPT_FORMAT=fmt, DORKNET_EPOCHS="3", DORKNET_START_EPOCH="2",
               DORKNET_RESTART_CKPT=ckpt[0], **path)
    assert any(f.startswith("epoch_2_testacc_") for f in os.listdir(exp))
    recs = read_metrics(str(tmp_path / "logging" / "TinyDogs.metrics.jsonl"))
    restarted = [r for r in recs if r.get("epoch") == 2 and "loss" in r]
    assert restarted and math.isfinite(restarted[0]["loss"])


def test_unported_paths_raise(run_script):
    """The host-augmentation default path and a JPEG tree raise, naming
    ROADMAP A5."""
    with pytest.raises(NotImplementedError, match="A5"):
        run_script(DORKNET_CKPT_FORMAT="torch", DORKNET_EPOCHS="2")
    os.makedirs(os.path.join("jpeg", "ImageNet2012", "ILSVRC2012_dogs", "train_img", "a"))
    with pytest.raises(NotImplementedError, match="A5"):
        run_script(DORKNET_CKPT_FORMAT="torch", DORKNET_EPOCHS="2", DORKNET_DATA="jpeg",
                   DORKNET_DEVICE_RESIDENT="1")
    with pytest.raises(ValueError, match="h5 or torch"):
        run_script(DORKNET_CKPT_FORMAT="npz", DORKNET_DEVICE_RESIDENT="1")
