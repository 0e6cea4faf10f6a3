"""MNIST loading (counterpart of
``dorknet_tpu/data_loading/MNIST_data_loading.py``, numpy only): the .npy
files of ``scripts/MNISTprepper.py`` (images (N, 784) uint8, labels (N,)),
a train/val/test split, /255 scaling, and a shuffled batch generator of
(X (B,1,28,28) float32, y, one_hot) triples drawn from numpy's global RNG,
as the JAX package draws them."""

import os

import numpy as np


def epoch_image_generator(X_full, y_full, batch_size=1, num_classes=10):
    shuffle_indices = np.random.permutation(X_full.shape[0])
    X_full = X_full[shuffle_indices]
    y_full = y_full[shuffle_indices]
    index = 0
    eye = np.eye(num_classes, dtype=np.float32)
    for _ in range(int(X_full.shape[0] / batch_size)):
        X_batch = X_full[index:index + batch_size].reshape((batch_size, 1, 28, 28))
        y_batch = y_full[index:index + batch_size]
        index += batch_size
        yield X_batch.astype(np.float32), y_batch, eye[y_batch]


def get_MNIST_data(num_training=59000, num_validation=1000, num_test=10000,
                   mnist_dir="MNIST_data"):
    X_train = np.load(os.path.join(mnist_dir, "MNISTTrainImages.npy")).astype(np.float32)
    y_train = np.load(os.path.join(mnist_dir, "MNISTTrainLabels.npy")).astype(np.int32)
    X_test = np.load(os.path.join(mnist_dir, "MNISTTestImages.npy")).astype(np.float32)
    y_test = np.load(os.path.join(mnist_dir, "MNISTTestLabels.npy")).astype(np.int32)

    X_val = X_train[num_training:num_training + num_validation]
    y_val = y_train[num_training:num_training + num_validation]
    X_train = X_train[:num_training]
    y_train = y_train[:num_training]
    X_test = X_test[:num_test]
    y_test = y_test[:num_test]

    X_train /= 255.0
    X_val /= 255.0
    X_test /= 255.0
    return X_train, y_train, X_val, y_val, X_test, y_test
