"""The MNIST basic convnet (the twin of ``examples/MNIST_basic_convnet.py``):
``MNISTNet``, batch 200, 14 epochs, SGDMomentum at lr 0.01 and momentum
0.9, the lr times 0.1 at every fifth epoch, each step one
``Trainer.step`` (``USE_FUSED_STEP = False`` takes the reference's
forward / backward / update loop instead), the test accuracy after each
epoch. Without ``tqdm``: each epoch prints its last loss and its images per
second.

It reads the .npy files of ``scripts/MNISTprepper.py`` from
``DORKNET_MNIST_DIR`` (``scripts/make_digits_mnist.py`` builds the same
layout from sklearn's digits). The run is on the card;
``DORKNET_DEVICE=cpu`` is for the tests.

Env knobs (defaults = the reference recipe):
    DORKNET_MNIST_DIR    data directory (default MNIST_data)
    DORKNET_EPOCHS       epochs (default 14)
    DORKNET_BATCH        batch size (default 200)
    DORKNET_NUM_TRAIN / DORKNET_NUM_VAL / DORKNET_NUM_TEST  split sizes
    DORKNET_METRICS      JSONL accuracy-trajectory sidecar path ('' = off)
    DORKNET_DEVICE       cuda (default) or cpu

Run:  python -m dorknet_tpu_torch.examples.MNIST_basic_convnet
"""

import os
import time

from dorknet_tpu_torch.data_loading import (device_prefetch, epoch_image_generator,
                                            get_MNIST_data)
from dorknet_tpu_torch.models import MNISTNet
from dorknet_tpu_torch.network import Trainer
from dorknet_tpu_torch.optimisers import SGDMomentum

MNIST_DIR = os.environ.get("DORKNET_MNIST_DIR", "MNIST_data")
BATCH_SIZE = int(os.environ.get("DORKNET_BATCH", "200"))
EPOCHS = int(os.environ.get("DORKNET_EPOCHS", "14"))
NUM_TRAIN = int(os.environ.get("DORKNET_NUM_TRAIN", "50000"))
NUM_VAL = int(os.environ.get("DORKNET_NUM_VAL", "10000"))
NUM_TEST = int(os.environ.get("DORKNET_NUM_TEST", "10000"))
METRICS = os.environ.get("DORKNET_METRICS", "")
DEVICE = os.environ.get("DORKNET_DEVICE", "cuda")
USE_FUSED_STEP = True


def main():
    if not os.path.isdir(MNIST_DIR):
        raise SystemExit("{}/ not found: run scripts/MNISTprepper.py on the idx files "
                         "(or scripts/make_digits_mnist.py).".format(MNIST_DIR))
    X_train, y_train, X_val, y_val, X_test, y_test = get_MNIST_data(
        num_training=NUM_TRAIN, num_validation=NUM_VAL, num_test=NUM_TEST,
        mnist_dir=MNIST_DIR)
    network = MNISTNet("MNISTDemo")
    sgd = SGDMomentum(network, 0.01, 0.9)
    trainer = Trainer(network, sgd, device=DEVICE)  # moves the network to DEVICE
    print(network)
    metrics = None
    if METRICS:
        from dorknet_tpu_torch.utils.metrics import MetricsLogger
        metrics = MetricsLogger(METRICS)

    for e in range(1, EPOCHS + 1, 1):
        print("Epoch {}:".format(e))
        if e % 5 == 0:
            sgd.multiply_learning_rate(0.1)
        batches = device_prefetch(
            epoch_image_generator(X_train, y_train, BATCH_SIZE, num_classes=10),
            device=DEVICE)
        loss, steps, t0 = None, 0, time.perf_counter()
        for X_batch, y_batch, y_one_hot in batches:
            if USE_FUSED_STEP:
                loss, _ = trainer.step(X_batch, y_one_hot)
            else:
                loss, batch_scores = network.forward(X_batch, y_one_hot)
                network.backward()
                sgd.update_weights()
            steps += 1
        loss = float(loss)  # waits for the epoch's last step
        train_img_s = steps * BATCH_SIZE / (time.perf_counter() - t0)
        print("{} steps, loss {:.4f}, {:.1f} img/s".format(steps, loss, train_img_s))
        print("Testing...")
        test_acc = network.test(
            epoch_image_generator(X_test, y_test, BATCH_SIZE, num_classes=10),
            BATCH_SIZE, len(X_test))
        print("Test acc: {}".format(test_acc))
        if metrics is not None:
            metrics.log(epoch=e, loss=loss, test_acc=float(test_acc),
                        lr=float(sgd.learning_rate), train_img_s=train_img_s)


if __name__ == "__main__":
    main()
