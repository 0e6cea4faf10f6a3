"""ImageNet-dogs ResNet-18-depsep training, the flagship example (the twin of
``examples/imagenet_dogs_225_resnet_18_depsep.py``).

The same model (``ResNet18``, the same layer names, so checkpoints are
interchangeable), batch 60, SGDMomentum at lr 0.05*(B/200) and momentum
0.9, the lr halved at epochs 16, 20 and 25, mixup (0, 0.3), validation and
an accuracy-stamped checkpoint every epoch (and the EMA network's, with
``DORKNET_EMA``), the restart flow, and the same ``DORKNET_*`` knobs. Two
input paths run, both with the augmentation and mixup on the card, in the
trainer's captured step:

* ``DORKNET_DEVICE_RESIDENT=1``: the packed training set lives on the card
  (``DeviceResidentDataset``) and each step moves only its row indices
  (``Trainer.step_augmented_indexed``); a set over ``DORKNET_HBM_BUDGET``
  bytes (8 GiB by default) falls back to the streaming path below;
* ``DORKNET_ON_DEVICE_AUGMENT=1``: the threaded loader streams uint8
  canvases from the packed directory (``emit_hwc_uint8``) into
  ``Trainer.step_augmented``.

``train_img`` and ``val_img`` under
``$DORKNET_DATA/ImageNet2012/ILSVRC2012_dogs/`` must be packed directories
(``data_loading/packed_dataset.py``). Packing a JPEG tree and the
reference's default path, augmentation on the host, need cv2, which the
port does not use yet (ROADMAP A5): they raise.

Checkpoints, ``DORKNET_CKPT_FORMAT``: ``h5`` (the default) writes the
reference's ``epoch_{e}_testacc_{acc}.h5`` and needs h5py, which the card's
machine lacks (a missing h5py raises: the format never changes by itself);
``torch`` writes ``epoch_{e}_testacc_{acc}.pt`` with the optimiser state and
the EMA (``utils/torch_io.py``). ``DORKNET_RESTART_CKPT`` names a file of
either kind in the experiment's directory; ``DORKNET_START_EPOCH`` sets the
epoch to resume at. The augmentation draws come from a ``torch.Generator``
seeded with the epoch. The run is on the card; ``DORKNET_DEVICE=cpu`` is
for the tests. Besides the reference's records, each epoch's metrics line
holds ``train_img_s``: the images trained per second of the epoch's loop,
which fetches every step's loss to the host, as the reference does.

Run:  DORKNET_DEVICE_RESIDENT=1 DORKNET_CKPT_FORMAT=torch \\
      python -m dorknet_tpu_torch.examples.imagenet_dogs_225_resnet_18_depsep
"""

import logging
import os
import time

import numpy as np
import torch

from dorknet_tpu_torch import config
from dorknet_tpu_torch.data_loading import (DeviceResidentDataset, ImageDataLoader,
                                            ImagePreprocessor, PackedDataset, device_prefetch,
                                            fits_in_hbm, is_packed_dir)
from dorknet_tpu_torch.models import ResNet18
from dorknet_tpu_torch.network import Trainer
from dorknet_tpu_torch.optimisers import SGDMomentum
from dorknet_tpu_torch.utils import torch_io
from dorknet_tpu_torch.utils.metrics import MetricsLogger

BATCH_SIZE = int(os.environ.get("DORKNET_BATCH", "60"))
data_folder = os.environ.get("DORKNET_DATA", os.path.expanduser("~/Datasets"))
ON_DEVICE_AUGMENT = os.environ.get("DORKNET_ON_DEVICE_AUGMENT", "0") == "1"
DEVICE_RESIDENT = os.environ.get("DORKNET_DEVICE_RESIDENT", "0") == "1"
IMAGE_SIZE = int(os.environ.get("DORKNET_IMAGE", "225"))
EPOCHS = int(os.environ.get("DORKNET_EPOCHS", "40"))          # exclusive bound
TRAIN_SET_SIZE = int(os.environ.get("DORKNET_TRAIN_SIZE", "150473"))
VAL_SET_SIZE = int(os.environ.get("DORKNET_VAL_SIZE", str(120 * 50)))
NUM_WORKERS = int(os.environ.get("DORKNET_WORKERS", "8"))
DEVICE = os.environ.get("DORKNET_DEVICE", "cuda")
CKPT_FORMAT = os.environ.get("DORKNET_CKPT_FORMAT", "h5")

AUG_CFG = dict(hsv_pert_tuples=((0.9, 1.1), (0.5, 2.0), (0.5, 2.0)),
               rotation_tuple=(-15.0, 15.0), horizontal_flip_prob=0.5)
DOGS = "ImageNet2012/ILSVRC2012_dogs"


def _require_packed(path):
    if not os.path.isdir(path):
        raise SystemExit(
            "Dataset not found: {}\nExpected a packed directory of the ImageNet-dogs "
            "classes (set DORKNET_DATA).".format(path))
    if not is_packed_dir(path):
        raise NotImplementedError(
            "{} is not a packed directory; packing a JPEG tree needs cv2, which the "
            "port does not use yet (ROADMAP A5)".format(path))


def _save_epoch(experiment_name, network, trainer, e, test_acc, ema_decay):
    stem = os.path.join(experiment_name, "epoch_{}_testacc_{}".format(e, test_acc))
    ema = os.path.join(experiment_name, "epoch_{}_ema".format(e))
    if CKPT_FORMAT == "torch":
        torch_io.save_checkpoint(stem + ".pt", network, trainer)
        if ema_decay is not None:
            torch_io.save_checkpoint(ema + ".pt", trainer.ema_network())
    else:
        network.save_weights_to_h5(stem + ".h5")
        if ema_decay is not None:
            trainer.ema_network().save_weights_to_h5(ema + ".h5")


if __name__ == "__main__":
    if CKPT_FORMAT not in ("h5", "torch"):
        raise ValueError("DORKNET_CKPT_FORMAT must be h5 or torch, got {!r}".format(
            CKPT_FORMAT))
    if CKPT_FORMAT == "h5":
        import h5py  # noqa: F401 (fail before training, not at the first save)
    if not (DEVICE_RESIDENT or ON_DEVICE_AUGMENT):
        raise NotImplementedError(
            "the reference's default path augments on the host, which needs cv2 "
            "(ROADMAP A5); set DORKNET_DEVICE_RESIDENT=1 or DORKNET_ON_DEVICE_AUGMENT=1")
    train_root = os.path.join(data_folder, DOGS, "train_img")
    val_root = os.path.join(data_folder, DOGS, "val_img")
    _require_packed(train_root)
    _require_packed(val_root)
    train_preprocessor = ImagePreprocessor(image_size=(IMAGE_SIZE, IMAGE_SIZE),
                                           crop_mode="random")
    pw, ph = train_preprocessor.precrop_size
    resident_ds = train_data_loader = None
    if DEVICE_RESIDENT:
        hbm_budget = int(os.environ.get("DORKNET_HBM_BUDGET", 8 << 30))
        if fits_in_hbm(PackedDataset(train_root), budget_bytes=hbm_budget):
            resident_ds = DeviceResidentDataset(train_root, BATCH_SIZE, class_balance=False,
                                                expect_precrop=(ph, pw), device=DEVICE)
        else:
            print("DEVICE_RESIDENT: packed dataset exceeds the device-memory budget; "
                  "falling back to the streaming packed loader (augmentation on the card)")
            DEVICE_RESIDENT = False
            ON_DEVICE_AUGMENT = True
    if not DEVICE_RESIDENT:
        train_data_loader = ImageDataLoader(train_root, BATCH_SIZE, train_preprocessor,
                                            class_balance=False, num_workers=NUM_WORKERS,
                                            emit_hwc_uint8=True)
    val_preprocessor = ImagePreprocessor(image_size=(IMAGE_SIZE, IMAGE_SIZE),
                                         crop_mode="center")
    val_data_loader = ImageDataLoader(val_root, BATCH_SIZE, val_preprocessor,
                                      num_workers=NUM_WORKERS)

    metrics = None
    try:
        restart_ckpt = os.environ.get("DORKNET_RESTART_CKPT", "")
        starting_epoch = int(os.environ.get("DORKNET_START_EPOCH", "1"))
        experiment_name = os.environ.get("DORKNET_EXPERIMENT", "DogsImageNet225ResNet18DepSep")
        os.makedirs("logging", exist_ok=True)
        logging.basicConfig(filename="logging/" + experiment_name + ".log", level=logging.DEBUG)
        logging.getLogger().addHandler(logging.StreamHandler())
        metrics = MetricsLogger("logging/" + experiment_name + ".metrics.jsonl")
        metrics.bind(batch=BATCH_SIZE, image_size=IMAGE_SIZE, on_device_augment=ON_DEVICE_AUGMENT,
                     device_resident=DEVICE_RESIDENT)
        network = ResNet18(experiment_name, load_layers=True)
        os.makedirs(experiment_name, exist_ok=True)
        json_path = os.path.join(experiment_name, experiment_name + ".json")
        network.save_layer_structure_to_json(json_path)
        if restart_ckpt.endswith(".h5"):
            network = ResNet18("", load_layers=False)
            network.load_network_from_json_and_h5(json_path,
                                                  os.path.join(experiment_name, restart_ckpt))
        print(network)
        if os.environ.get("DORKNET_BF16", "0") == "1":
            config.set_compute_dtype(torch.bfloat16)
            logging.info("bf16 activation-flow policy enabled")
        ema_decay = float(os.environ.get("DORKNET_EMA", "0") or 0) or None
        # mixup on the card trains both convex orderings in one step (2B
        # images), so the reference's linear lr rule takes 2B and an epoch
        # half the pulls
        effective_batch = 2 * BATCH_SIZE
        sgd = SGDMomentum(network, 0.05 * (effective_batch / 200.0), 0.9)
        trainer = Trainer(network, sgd, ema_decay=ema_decay, device=DEVICE)
        if restart_ckpt.endswith(".pt"):
            # parameters, running stats, momentum and EMA, in place
            torch_io.load_checkpoint(os.path.join(experiment_name, restart_ckpt), network, trainer)
        elif restart_ckpt and not restart_ckpt.endswith(".h5"):
            raise ValueError("DORKNET_RESTART_CKPT must name a .h5 or a .pt file, got {!r}".format(
                restart_ckpt))
        logging.info(network)
        generator = torch.Generator(device=trainer.device)

        for e in range(starting_epoch, EPOCHS, 1):
            running_loss_average = None
            logging.info("Epoch {}:".format(e))
            logging.info("Shuffling data: ")
            (resident_ds if DEVICE_RESIDENT else train_data_loader).shuffle_indices()
            correct_total = 0
            if e == 16 or e == 20 or e == 25:
                logging.info("Multiplying learning rate by 0.5")
                sgd.multiply_learning_rate(0.5)
            steps = max(1, int(TRAIN_SET_SIZE / BATCH_SIZE / 2))
            if DEVICE_RESIDENT:
                batches = (resident_ds.next_indices() for _ in range(steps))
            else:
                batches = device_prefetch(train_data_loader.pull_batch(steps),
                                          device=trainer.device)
            # one generator, reseeded each epoch: a captured step reads it
            # by identity, so the epochs share one graph
            generator.manual_seed(e)
            t0 = time.perf_counter()
            for i, item in enumerate(batches):
                if DEVICE_RESIDENT:
                    rows = item
                    y_batch = resident_ds.packed.labels[rows]
                    loss, preds = trainer.step_augmented_indexed(
                        generator, resident_ds.images, resident_ds.labels, rows,
                        (IMAGE_SIZE, IMAGE_SIZE), resident_ds.num_classes,
                        crop_mode="random", mixup=(0.0, 0.3), **AUG_CFG)
                else:
                    X_batch, y_batch, y_one_hot = item
                    loss, preds = trainer.step_augmented(
                        generator, X_batch, y_one_hot, (IMAGE_SIZE, IMAGE_SIZE),
                        crop_mode="random", mixup=(0.0, 0.3), **AUG_CFG)
                loss = float(loss)
                if running_loss_average is None:
                    running_loss_average = loss
                else:
                    running_loss_average = 0.9 * running_loss_average + 0.1 * loss
                # mixup doubles the batch; its first half is dominated by the
                # original labels (lam <= 0.3)
                preds_np = preds.cpu().numpy()[:len(y_batch)]
                correct_total += int(np.sum(np.asarray(y_batch) == preds_np))
                if i % 10 == 0:
                    logging.info("Running loss average: {}".format(running_loss_average))
                    metrics.log(epoch=e, step=i, loss=loss, loss_avg=running_loss_average,
                                lr=sgd.learning_rate)
                if (i % 100 == 0) and (i > 0):
                    logging.info(
                        "Running Ave Loss: {}, Loss: {}, Accuracy over current epoch so "
                        "far: {} ".format(running_loss_average, loss,
                                          correct_total / (i * BATCH_SIZE)))
            train_seconds = time.perf_counter() - t0
            logging.info("Testing...")
            test_acc = network.test(val_data_loader.pull_batch(
                max(1, int(VAL_SET_SIZE / BATCH_SIZE))), BATCH_SIZE, VAL_SET_SIZE)
            logging.info("Test acc: {}".format(test_acc))
            metrics.log(epoch=e, test_acc=test_acc,
                        epoch_train_acc=correct_total / (steps * BATCH_SIZE),
                        train_seconds=train_seconds,
                        train_img_s=steps * effective_batch / train_seconds)
            _save_epoch(experiment_name, network, trainer, e, test_acc, ema_decay)
    finally:
        if train_data_loader is not None:
            train_data_loader.stop_thread()
        val_data_loader.stop_thread()
        if metrics is not None:
            metrics.close()
