"""The training input path (counterpart of ``dorknet_tpu.data_loading``):
the MNIST npy loader, packed datasets, the threaded loader over them and its preprocessor, the
device-resident dataset, prefetch, and the augmentation pipeline on the
card. ``mixup_pair`` here is the card's; the loader's host mixup is
``image_data_loader.mixup_pair``."""

from dorknet_tpu_torch.data_loading.MNIST_data_loading import (
    epoch_image_generator, get_MNIST_data)
from dorknet_tpu_torch.data_loading.device_augment import (
    augment_batch_planes, draw_batch_params, draw_mixup, mixup_pair, train_pipeline)
from dorknet_tpu_torch.data_loading.device_dataset import DeviceResidentDataset, fits_in_hbm
from dorknet_tpu_torch.data_loading.image_data_loader import ImageDataLoader
from dorknet_tpu_torch.data_loading.image_preprocessor import ImagePreprocessor, default_precrop
from dorknet_tpu_torch.data_loading.packed_dataset import (
    PACKED_FORMAT, PACKED_META, PackedDataset, is_packed_dir, write_packed_arrays)
from dorknet_tpu_torch.data_loading.prefetch import device_prefetch, stack_batches

__all__ = [
    "epoch_image_generator",
    "get_MNIST_data",
    "augment_batch_planes",
    "draw_batch_params",
    "draw_mixup",
    "mixup_pair",
    "train_pipeline",
    "DeviceResidentDataset",
    "fits_in_hbm",
    "ImageDataLoader",
    "ImagePreprocessor",
    "default_precrop",
    "PACKED_FORMAT",
    "PACKED_META",
    "PackedDataset",
    "is_packed_dir",
    "write_packed_arrays",
    "device_prefetch",
    "stack_batches",
]
